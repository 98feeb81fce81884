"""Keyed random draws for exported entry points.

A ``torch.Generator`` cannot be an input of an exported program, so an
exported entry point takes one int64 ``key`` tensor first, as the JAX
package's artifacts take one PRNG key, and draws from ``KeyedDraws(key)``:
the interface of ``models/base.py::Draws`` computed from a counter-based
integer hash of (key, draw index, element index) in plain int64 tensor
ops. It traces (a symbolic batch stays symbolic), gives the same numbers
for the same key and differs for different keys; the integer draws
(``uniform``'s 24 bits, ``bernoulli``, ``randint``, ``permutation``) are
bit-equal on the CPU and on the card, the float transforms of them
(``normal``, ``gumbel``, ``cauchy``, ``gamma``) equal within the last
bits of the device's ``log`` / ``cos`` / ``tan``. The numbers match JAX's
in distribution only, as every draw of the port does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_LANE = 0x632BE5AB

#: proposals per element of ``KeyedDraws.gamma``
GAMMA_PROPOSALS = 4


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in 16-bit halves so that no int64 product overflows."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (``lowbias32``) of int64 ``x`` in
    [0, 2**32); the shifts are logical because ``x`` is non-negative."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class KeyedDraws:
    """Random draws keyed by an int64 tensor ``key`` (0-d).

    Draw ``i`` of a provider hashes every element index ``j`` as
    ``mix(mix(j ^ s1) ^ s2)`` with (s1, s2) hashed from (key, i): 32
    random bits per element, a bijection of ``j`` within one draw.
    ``uniform``: the top 24 bits over 2**24, in [0, 1); ``gumbel``:
    ``-log(-log(u))`` with u clamped to (tiny, 1), as ``Draws`` draws it;
    ``bernoulli(p)``: ``uniform < p``; ``normal``: Box-Muller of two
    uniforms; ``randint(low, high)``: ``low + bits * (high - low) >> 32``;
    ``cauchy``: ``tan(pi * (u - 1/2))``; ``permutation(rows, n)``: the
    stable argsort of one ``uniform`` draw per row; ``gamma(alpha)``:
    Gamma(alpha, 1) without gradient, Marsaglia and Tsang's method with
    ``GAMMA_PROPOSALS`` proposals per element (an ``alpha`` below 1 draws
    at ``alpha + 1`` and scales by ``u ** (1 / alpha)``); the first
    accepted proposal is taken, and an element whose proposals are all
    rejected (at ``alpha`` >= 1 each is accepted with probability above
    0.95, above 0.99 from ``alpha`` = 8) takes ``alpha - 1/3``, the
    method's centre. Every draw returns float32 (int64 for ``randint``
    and ``permutation``, bool for ``bernoulli``) on the key's device."""

    def __init__(self, key: torch.Tensor,
                 device: Optional[torch.device] = None):
        key = torch.as_tensor(key, dtype=torch.int64)
        self.device = device if device is not None else key.device
        key = key.to(self.device).reshape(())
        self._lo = key & _M32
        self._hi = (key >> 32) & _M32
        self._count = 0

    def _bits(self, shape: Sequence[int]) -> torch.Tensor:
        """32 random bits per element (int64 in [0, 2**32)) of ``shape``."""
        i = self._count
        self._count += 1
        seed = _mix32(self._hi ^ _mix32(self._lo ^ ((i * _GOLDEN) & _M32)))
        s1, s2 = _mix32(seed), _mix32(seed ^ _LANE)
        j = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=self.device)
        return _mix32(_mix32(j ^ s1) ^ s2).reshape(tuple(shape))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return (self._bits(shape) >> 8).to(torch.float32) * (1.0 / 2 ** 24)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(shape).clamp(min=tiny)
        return -torch.log(-torch.log(u))

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        return self.uniform(shape) < p

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        u = self.uniform((2, *shape))
        r = torch.sqrt(-2.0 * torch.log(1.0 - u[0]))
        return r * torch.cos((2.0 * math.pi) * u[1])

    def randint(self, low: int, high: int, shape: Sequence[int]
                ) -> torch.Tensor:
        return low + ((self._bits(shape) * (high - low)) >> 32)

    def gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        a = alpha.detach().to(self.device, torch.float32)
        boost = a < 1.0
        d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
        c = torch.rsqrt(9.0 * d)
        x = self.normal((GAMMA_PROPOSALS, *a.shape))
        u = self.uniform((GAMMA_PROPOSALS, *a.shape))
        scale = self.uniform(a.shape)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
        value = torch.gather(d * v, 0, first)[0]
        value = torch.where(ok.any(0), value, d)
        return torch.where(boost, value * scale ** (1.0 / a), value)

    def cauchy(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.tan(math.pi * (self.uniform(shape) - 0.5))

    def permutation(self, rows: int, n: int) -> torch.Tensor:
        return torch.argsort(self.uniform((rows, n)), dim=1, stable=True)
