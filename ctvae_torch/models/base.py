"""Loss helpers, random-draw provider and init helpers of the model zoo.

Counterpart of ``ctvae_tpu/models/base.py``. JAX and PyTorch give
different numbers from the same seed, so every random draw of the CT
forward goes through a ``Draws`` provider that the model calls in the JAX
package's order; a test substitutes a provider that replays given arrays.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.common import upcast32

# PRNG stream names of the JAX package (kept for its serving conventions).
RNG_STREAMS = ("reparam", "gumbel", "noise", "dropout")


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-reduced MSE, matching ``F.mse_loss`` defaults."""
    return torch.mean(torch.square(upcast32(pred) - upcast32(target)))


def cross_entropy_from_probs(probs: torch.Tensor, labels: torch.Tensor,
                             eps: float = 1e-4) -> torch.Tensor:
    """``F.cross_entropy(p.clamp(min=eps).log(), y)``: the clamped
    log-probs are treated as logits (one more log_softmax)."""
    logits = torch.log(torch.clamp(upcast32(probs), min=eps))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())
    return torch.mean(nll)


class Draws:
    """Random draws of the CT forward, from one ``torch.Generator``.

    ``gumbel(shape)``: standard Gumbel noise (the intervention mask, then
    the edge sample); ``uniform(shape)``: U[0, 1) (the KL target);
    ``bernoulli(p, shape)``: a bool mask, True with probability ``p`` (the
    dropout keep mask, drawn only under ``train``); ``normal(shape)``:
    standard normal latents (``sample``, ``walk``); ``randint(low, high,
    shape)``: int64 in [low, high) (``walk``'s channel choice)."""

    def __init__(self, generator: torch.Generator,
                 device: Optional[torch.device] = None):
        self.generator = generator
        self.device = device if device is not None else generator.device

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        # -log(-log(u)) with u in (tiny, 1), as jax.random.gumbel draws it
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(shape).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        return self.uniform(shape) < p

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def randint(self, low: int, high: int, shape: Sequence[int]
                ) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator, device=self.device)


def dropout(x: torch.Tensor, rate: float, draws: Draws, train: bool
            ) -> torch.Tensor:
    """flax's ``nn.Dropout``: under ``train``, keep each element with
    probability ``1 - rate`` (one ``bernoulli`` draw of ``x``'s shape) and
    scale the kept ones by ``1 / (1 - rate)``; otherwise the identity."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = draws.bernoulli(keep, x.shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def lecun_normal(shape: Sequence[int], fan_in: int,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two deviations,
    rescaled so the variance is ``1 / fan_in`` (drawn by inverse CDF)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2.0) * std
