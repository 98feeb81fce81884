"""WAE_MMD: the Wasserstein autoencoder with an MMD penalty, on the
deterministic encoder (``fc_z``, no reparameterisation).

Counterpart of ``ctvae_tpu/models/wae_mmd.py``: the MMD is scaled by
``reg_weight / (B (B - 1))``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .base import Draws, mse_loss
from .gaussian_base import StandardGaussianVAE
from .mmd import compute_mmd


class WAE_MMD(StandardGaussianVAE):

    cross_batch_loss = (
        "the MMD pairs every two rows of the batch's latents (models/mmd.py)")

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = True,
                 dtype="float32", reg_weight: float = 100.0,
                 kernel_type: str = "imq", latent_var: float = 2.0, *,
                 device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.reg_weight, self.kernel_type = reg_weight, kernel_type
        self.latent_var = latent_var

    def loss_function(self, outputs: Dict, *, draws: Draws,
                      **kwargs) -> Dict:
        z = outputs["z"]
        reg = self.reg_weight / (z.shape[0] * (z.shape[0] - 1))
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        mmd = reg * compute_mmd(draws, z, self.kernel_type, self.latent_var)
        return {"loss": recons_loss + mmd,
                "Reconstruction_Loss": recons_loss, "MMD": mmd}
