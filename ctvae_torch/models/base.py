"""The zoo's base class, loss helpers, random-draw provider and init
helpers.

Counterpart of ``ctvae_tpu/models/base.py``. JAX and PyTorch give
different numbers from the same seed, so every random draw of a forward
or a loss goes through a ``Draws`` provider that the model calls in the
JAX package's order; a test substitutes a provider that replays given
arrays.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.common import upcast32

# PRNG stream names of the JAX package (kept for its serving conventions).
RNG_STREAMS = ("reparam", "gumbel", "noise", "dropout")


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-reduced MSE, matching ``F.mse_loss`` defaults."""
    return torch.mean(torch.square(upcast32(pred) - upcast32(target)))


def gaussian_kl(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)) summed over the latent, averaged over
    the batch."""
    mu, log_var = upcast32(mu), upcast32(log_var)
    per_ex = -0.5 * torch.sum(1.0 + log_var - torch.square(mu)
                              - torch.exp(log_var), dim=1)
    return torch.mean(per_ex)


def cross_entropy_from_probs(probs: torch.Tensor, labels: torch.Tensor,
                             eps: float = 1e-4) -> torch.Tensor:
    """``F.cross_entropy(p.clamp(min=eps).log(), y)``: the clamped
    log-probs are treated as logits (one more log_softmax)."""
    logits = torch.log(torch.clamp(upcast32(probs), min=eps))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())
    return torch.mean(nll)


class Draws:
    """Random draws of a forward and its loss, from one ``torch.Generator``.

    ``gumbel(shape)``: standard Gumbel noise (the intervention mask, then
    the edge sample); ``uniform(shape)``: U[0, 1) (the KL target);
    ``bernoulli(p, shape)``: a bool mask, True with probability ``p`` (the
    dropout keep mask, drawn only under ``train``); ``normal(shape)``:
    standard normals (``sample``, ``walk``, the noise nodes, the
    reparameterisation, the MMD's prior); ``randint(low, high, shape)``:
    int64 in [low, high) (``walk``'s channel choice, the EMA revival,
    the categorical priors); ``gamma(alpha)``: Gamma(alpha, 1) of
    ``alpha``'s shape, one shape per element, without gradient
    (GammaVAE); ``cauchy(shape)``: standard Cauchy (SWAE's
    projections); ``permutation(rows, n)``: int64 [rows, n], each row an
    independent permutation of range(n) (FactorVAE's permuted latent),
    the stable argsort of one ``uniform`` draw."""

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

    def gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(alpha.detach().to(self.device),
                                     generator=self.generator)

    def cauchy(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.empty(tuple(shape), device=self.device).cauchy_(
            generator=self.generator)

    def permutation(self, rows: int, n: int) -> torch.Tensor:
        return torch.argsort(self.uniform((rows, n)), dim=1, stable=True)


class ShardedDraws:
    """The draws of one rank of a data-parallel step
    (``parallel/mesh.py``): each draw of a batch-leading shape is made at
    the global shape by ``base`` (whose generator every rank holds in
    lockstep) and the rank keeps its rows, so every rank's draws are its
    rows of the single process's on the global batch, and the generators
    stay in lockstep. Rank r of the n ranks of ``group`` (the batch group:
    under a mesh with a model axis, r is the data index, so the ranks of
    one model group draw the same values) keeps rows r B to (r + 1) B of
    the global n B; under ``grouped(G)`` a leading dim of G B is G blocks
    of the batch, block-major (the causal mode's virtual batch of A
    actions), and the rank keeps its B rows of each block. ``gamma``
    gathers the ranks' ``alpha`` first (a gamma draw consumes the stream
    by its shapes). ``replicated()`` is ``base``: a draw of the same
    values on every rank (the EMA revival's row picks)."""

    def __init__(self, base, group, groups: int = 1):
        from ..parallel.mesh import group_rank, group_size
        self.base, self.group, self.groups = base, group, groups
        self.device = getattr(base, "device", None)
        self.world, self.rank = group_size(group), group_rank(group)

    def grouped(self, groups: int) -> "ShardedDraws":
        return ShardedDraws(self.base, self.group, self.groups * groups)

    def replicated(self):
        return self.base

    def _global(self, shape: Sequence[int]) -> tuple:
        shape = tuple(shape)
        if not shape or shape[0] % self.groups:
            raise ValueError(f"draw of shape {shape} is not {self.groups} "
                             f"blocks of batch rows")
        return (shape[0] * self.world,) + shape[1:]

    def _mine(self, a: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        b = shape[0] // self.groups
        a = a.reshape((self.groups, self.world, b) + shape[1:])
        return a[:, self.rank].reshape(shape)

    def uniform(self, shape):
        return self._mine(self.base.uniform(self._global(shape)), shape)

    def gumbel(self, shape):
        return self._mine(self.base.gumbel(self._global(shape)), shape)

    def bernoulli(self, p, shape):
        return self._mine(self.base.bernoulli(p, self._global(shape)), shape)

    def normal(self, shape):
        return self._mine(self.base.normal(self._global(shape)), shape)

    def randint(self, low, high, shape):
        return self._mine(self.base.randint(low, high, self._global(shape)),
                          shape)

    def cauchy(self, shape):
        return self._mine(self.base.cauchy(self._global(shape)), shape)

    def gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_gather_rows
        if self.groups != 1:
            raise ValueError("a grouped gamma draw is not defined")
        full = all_gather_rows(alpha.detach().contiguous(), self.group)
        return self._mine(self.base.gamma(full), alpha.shape)

    def permutation(self, rows: int, n: int) -> torch.Tensor:
        return self._mine(self.base.permutation(*self._global((rows, n))),
                          (rows, n))


def grouped(draws, groups: int):
    """``draws`` for draws whose leading dim is ``groups`` blocks of the
    batch, block-major (``ShardedDraws.grouped``); a single process's
    draws as they are."""
    return draws.grouped(groups) if isinstance(draws, ShardedDraws) \
        else draws


def unsharded(draws):
    """``draws`` that draw at the shape asked for on every rank alike: a
    ``ShardedDraws``' base (``replicated``), so a term of the global batch
    draws at the global shape as one process does; a single process's
    draws as they are."""
    return draws.replicated() if isinstance(draws, ShardedDraws) \
        else draws


def reparameterize(mu: torch.Tensor, log_var: torch.Tensor, draws: Draws
                   ) -> torch.Tensor:
    """The reparameterisation trick: ``mu + eps * exp(log_var / 2)`` with
    ``eps`` one ``normal`` draw of ``mu``'s shape."""
    std = torch.exp(0.5 * log_var)
    return mu + draws.normal(std.shape).to(std) * std


class BaseVAE(nn.Module):
    """The surface of the Gaussian and VQ members of the zoo:
    ``encode`` / ``decode`` / ``forward`` (a dict of named tensors) /
    ``loss_function`` and ``generate``. A model with a usable prior also
    defines ``sample``; one without (VQVAE, whose codes have no prior)
    defines none, and the loop and the serving entry points check for it."""

    def generate(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Reconstruct ``x`` (the forward's ``recons``)."""
        return self(x, **kwargs)["recons"]

    def loss_function(self, outputs: Dict, **kwargs) -> Dict:
        raise NotImplementedError


#: the compute dtypes the port takes, by the names a YAML or flax gives
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_dtype(dtype) -> torch.dtype:
    """The torch dtype of a model's ``dtype`` field: "float32" or
    "bfloat16" (or the torch dtype, or its ``str``), which every member
    of the registry and TwoStageVAE takes; any other dtype (float64
    among them) raises ``NotImplementedError`` (ROADMAP A6)."""
    name = str(dtype).replace("torch.", "")
    got = COMPUTE_DTYPES.get(name)
    if got is None:
        raise NotImplementedError(f"not ported yet: dtype={dtype!r} "
                                  f"(ROADMAP A6)")
    return got


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
