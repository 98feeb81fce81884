"""MIWAE: the multiply-importance-weighted autoencoder, M estimates of S
samples each.

Counterpart of ``ctvae_tpu/models/miwae.py``: one ``normal`` draw of
shape [B, M, S, D], the decoder on the B * M * S latents, and the mean
over the M estimates of each estimate's IWAE objective. ``recons`` is
[B, M, S, H, W, C]; ``generate`` returns estimate 0's sample 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .base import Draws
from .iwae import IWAE, importance_weighted


class MIWAE(IWAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", num_samples: int = 5,
                 num_estimates: int = 5, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, num_samples, device=device)
        self.num_estimates = num_estimates

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        return self._samples(x, (self.num_estimates, self.num_samples),
                             train, draws)

    def generate(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self(x, **kwargs)["recons"][:, 0, 0]

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        return importance_weighted(outputs["recons"],
                                   outputs["input"][:, None, None],
                                   outputs["mu"], outputs["log_var"], M_N, 3)
