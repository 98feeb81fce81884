"""SWAE: the Sliced-Wasserstein autoencoder, a deterministic encoder and
the sort-based 1-D Wasserstein distance over random projections.

Counterpart of ``ctvae_tpu/models/swae.py``. The loss draws the prior's
``normal`` [B, D] first, then the projections, ``normal`` or ``cauchy``
[P, D], each normalised to unit length. In a data-parallel step the
distance is the global batch's: ``z`` gathered from the ranks, the prior
and the projections drawn at the global shapes, B the global rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..parallel.mesh import gather_batch
from .base import Draws, mse_loss, unsharded, upcast32
from .gaussian_base import StandardGaussianVAE


class SWAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = True,
                 dtype="float32", reg_weight: float = 100.0,
                 wasserstein_deg: float = 2.0, num_projections: int = 50,
                 projection_dist: str = "normal", *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.reg_weight, self.wasserstein_deg = reg_weight, wasserstein_deg
        self.num_projections = num_projections
        self.projection_dist = projection_dist

    def _random_projections(self, draws: Draws) -> torch.Tensor:
        shape = (self.num_projections, self.latent_dim)
        if self.projection_dist == "normal":
            samples = draws.normal(shape)
        elif self.projection_dist == "cauchy":
            samples = draws.cauchy(shape)
        else:
            raise ValueError("Unknown projection distribution.")
        return samples / torch.linalg.norm(samples, dim=1, keepdim=True)

    def compute_swd(self, z: torch.Tensor, draws: Draws) -> torch.Tensor:
        z = gather_batch(upcast32(z))
        draws = unsharded(draws)
        batch_size = z.shape[0]
        reg = self.reg_weight / (batch_size * (batch_size - 1))
        prior_z = draws.normal(z.shape).to(z)
        proj = self._random_projections(draws).to(z).T          # [D, P]
        latent_proj = z @ proj                                  # [N, P]
        prior_proj = prior_z @ proj
        w_dist = (torch.sort(latent_proj.T, dim=1).values
                  - torch.sort(prior_proj.T, dim=1).values)
        return reg * torch.mean(torch.pow(w_dist, self.wasserstein_deg))

    def loss_function(self, outputs: Dict, *, draws: Draws,
                      **kwargs) -> Dict:
        recons, x, z = outputs["recons"], outputs["input"], outputs["z"]
        l2 = mse_loss(recons, x)
        l1 = torch.mean(torch.abs(recons - x))
        swd = self.compute_swd(z, draws)
        return {"loss": l2 + l1 + swd, "Reconstruction_Loss": l2 + l1,
                "SWD": swd}
