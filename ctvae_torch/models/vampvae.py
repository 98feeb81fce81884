"""VampVAE: a VAE with the VampPrior, a mixture over learned
pseudo-inputs.

Counterpart of ``ctvae_tpu/models/vampvae.py``. The pseudo-inputs
(``embed_pseudo`` of the identity, clipped to [0, 1], as images) go
through the same encoder in the same forward, after the batch: under
``train`` BatchNorm's running statistics take the batch's, then the
decoder's, then the pseudo-images' (flax's order). The Gaussian energy
keeps the reference's parenthesisation, ``-0.5 * (log_var + (z -
mu)^2) / exp(log_var)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..ops.layers import Linear, set_compute_dtype
from .base import Draws, mse_loss
from .gaussian_base import StandardGaussianVAE


class VampVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", num_components: int = 50, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.num_components = num_components
        self.embed_pseudo = Linear(num_components,
                                   img_size * img_size * in_channels,
                                   device=device)
        set_compute_dtype(self, self.compute_dtype)

    def _pseudo_images(self) -> torch.Tensor:
        eye = torch.eye(self.num_components, device=self.device)
        x = torch.clamp(self.embed_pseudo(eye), 0.0, 1.0)  # Hardtanh(0, 1)
        return x.reshape(-1, self.img_size, self.img_size, self.in_channels)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        out = super().forward(x, train=train, draws=draws, **kwargs)
        out["prior_mu"], out["prior_log_var"] = self.encode(
            self._pseudo_images(), train=train)
        return out

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        mu, log_var, z = outputs["mu"], outputs["log_var"], outputs["z"]
        prior_mu = outputs["prior_mu"][None]            # [1, K, D]
        prior_lv = outputs["prior_log_var"][None]

        E_log_q_z = torch.mean(torch.sum(
            -0.5 * (log_var + torch.square(z - mu)) / torch.exp(log_var),
            dim=1))
        E_log_p_z = (torch.sum(
            -0.5 * (prior_lv + torch.square(z[:, None, :] - prior_mu))
            / torch.exp(prior_lv), dim=2)
            - math.log(float(self.num_components)))
        E_log_p_z = torch.mean(torch.logsumexp(E_log_p_z, dim=1))

        kld = -(E_log_p_z - E_log_q_z)
        return {"loss": recons_loss + M_N * kld,
                "Reconstruction_Loss": recons_loss, "KLD": -kld}
