"""IWAE: the importance-weighted autoencoder, S samples per input.

Counterpart of ``ctvae_tpu/models/iwae.py``. One ``normal`` draw of
shape [B, S, D] reparameterises the S samples (in eval as in train), the
decoder runs on the B * S latents, and the softmax's self-normalised
weights multiply the per-sample objective while staying differentiable,
as the reference keeps them. ``recons`` is [B, S, H, W, C]; ``generate``
returns sample 0, while the ``reconstruct`` entry point serves the whole
``recons`` as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .base import Draws, reparameterize
from .gaussian_base import StandardGaussianVAE


def importance_weighted(recons: torch.Tensor, x: torch.Tensor,
                        mu: torch.Tensor, log_var: torch.Tensor, M_N: float,
                        lead: int) -> Dict:
    """The IWAE objective over the ``lead`` leading sample axes of
    ``recons`` / ``mu`` / ``log_var`` (``x`` broadcast to them), softmax
    over the last: (loss averaged over every axis but the last, the
    per-sample reconstruction, the per-sample KL)."""
    log_p_x_z = torch.mean(torch.square(recons - x).reshape(
        *recons.shape[:lead], -1), dim=-1)
    kld = -0.5 * torch.sum(1 + log_var - torch.square(mu)
                           - torch.exp(log_var), dim=lead)
    log_weight = log_p_x_z + M_N * kld
    weight = torch.softmax(log_weight, dim=-1)
    loss = torch.sum(weight * log_weight, dim=-1)
    while loss.dim():
        loss = torch.mean(loss, dim=-1)
    return {"loss": loss, "Reconstruction_Loss": torch.mean(log_p_x_z),
            "KLD": -torch.mean(kld)}


class IWAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", num_samples: int = 5, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.num_samples = num_samples

    def _samples(self, x: torch.Tensor, lead: tuple, train: bool,
                 draws: Draws) -> Dict:
        mu, log_var = self.encode(x, train=train)
        B, D = mu.shape
        shape = (B, *lead, D)
        mu_s = mu.reshape(B, *(1,) * len(lead), D).expand(shape)
        lv_s = log_var.reshape(B, *(1,) * len(lead), D).expand(shape)
        z = reparameterize(mu_s, lv_s, draws)
        recons = self.decode(z.reshape(-1, D), train=train)
        return {"recons": recons.reshape(*shape[:-1], *recons.shape[1:]),
                "input": x, "mu": mu_s, "log_var": lv_s, "z": z}

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        return self._samples(x, (self.num_samples,), train, draws)

    def generate(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self(x, **kwargs)["recons"][:, 0]

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        return importance_weighted(outputs["recons"],
                                   outputs["input"][:, None], outputs["mu"],
                                   outputs["log_var"], M_N, 2)
