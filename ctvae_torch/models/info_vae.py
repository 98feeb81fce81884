"""InfoVAE: the mixed MMD + KL objective.

Counterpart of ``ctvae_tpu/models/info_vae.py``: ``beta * recons + (1 -
alpha) * M_N * KL + (alpha + reg_weight - 1) / (B (B - 1)) * MMD``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .base import Draws, gaussian_kl, mse_loss
from .gaussian_base import StandardGaussianVAE
from .mmd import compute_mmd


class InfoVAE(StandardGaussianVAE):

    cross_batch_loss = (
        "the MMD pairs every two rows of the batch's latents (models/mmd.py)")

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", alpha: float = -0.5, beta: float = 5.0,
                 reg_weight: float = 100.0, kernel_type: str = "imq",
                 latent_var: float = 2.0, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        if alpha > 0:
            raise ValueError("alpha must be negative or zero.")
        self.alpha, self.beta, self.reg_weight = alpha, beta, reg_weight
        self.kernel_type, self.latent_var = kernel_type, latent_var

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      draws: Draws, **kwargs) -> Dict:
        z = outputs["z"]
        bias_corr = z.shape[0] * (z.shape[0] - 1)
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        mmd = compute_mmd(draws, z, self.kernel_type, self.latent_var)
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        loss = (self.beta * recons_loss + (1.0 - self.alpha) * M_N * kld
                + (self.alpha + self.reg_weight - 1.0) / bias_corr * mmd)
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "MMD": mmd, "KLD": -kld}
