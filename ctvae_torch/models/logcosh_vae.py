"""LogCoshVAE: the log-cosh reconstruction loss.

Counterpart of ``ctvae_tpu/models/logcosh_vae.py``, in its stable form
``log cosh(a t) = |a t| + log1p(exp(-2 |a t|)) - log 2``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..ops.common import upcast32
from .base import gaussian_kl
from .gaussian_base import StandardGaussianVAE


class LogCoshVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", alpha: float = 100.0, beta: float = 10.0,
                 *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.alpha, self.beta = alpha, beta

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        t = upcast32(outputs["recons"] - outputs["input"])
        at = torch.abs(self.alpha * t)
        rl = at + torch.log1p(torch.exp(-2.0 * at)) - math.log(2.0)
        recons_loss = torch.mean(rl) / self.alpha
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        loss = recons_loss + self.beta * M_N * kld
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": -kld}
