"""BetaVAE: the beta-weighted KL (``loss_type`` H) or the capacity-annealed
objective (B).

Counterpart of ``ctvae_tpu/models/beta_vae.py``. The capacity ``C`` grows
with the global ``step`` the train step passes (a tensor on the model's
device, so a captured CUDA graph reads each replay's step), counted from
``step + 1`` as the reference increments its counter first. In a
data-parallel step the KL of ``loss_type`` B is the global batch's mean
(``parallel/mesh.py::sum_batch``) before ``|KL - C|``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..parallel.mesh import batch_world, sum_batch
from .base import gaussian_kl, mse_loss
from .gaussian_base import StandardGaussianVAE


class BetaVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", beta: float = 4.0, gamma: float = 1000.0,
                 max_capacity: float = 25.0, Capacity_max_iter: float = 1e5,
                 loss_type: str = "B", *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        if loss_type not in ("H", "B"):
            raise ValueError("Undefined loss type.")
        self.beta, self.gamma, self.loss_type = beta, gamma, loss_type
        self.max_capacity = max_capacity
        self.Capacity_max_iter = Capacity_max_iter

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0, step=0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        if self.loss_type == "B":
            kld = sum_batch(kld) / batch_world()
        if self.loss_type == "H":
            loss = recons_loss + self.beta * M_N * kld
        else:
            step_f = torch.as_tensor(step, device=kld.device).float() + 1.0
            C = torch.clamp(self.max_capacity / self.Capacity_max_iter
                            * step_f, 0.0, self.max_capacity)
            loss = recons_loss + self.gamma * M_N * torch.abs(kld - C)
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": kld}
