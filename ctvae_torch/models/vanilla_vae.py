"""VanillaVAE: the Gaussian VAE with an MSE reconstruction and the KL.

Counterpart of ``ctvae_tpu/models/vanilla_vae.py``.
"""

from __future__ import annotations

from typing import Dict

from .base import gaussian_kl, mse_loss
from .gaussian_base import StandardGaussianVAE


class VanillaVAE(StandardGaussianVAE):

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        return {"loss": recons_loss + M_N * kld,
                "Reconstruction_Loss": recons_loss, "KLD": -kld}
