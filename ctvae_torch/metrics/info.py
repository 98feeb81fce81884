"""Discretisation and discrete mutual information of the metrics.

``discretize`` is the JAX package's ``_discretize``: 20 equal-width bins
per column with the edges ``np.histogram`` makes (computed in the column's
dtype; a constant column spans [v - 0.5, v + 0.5]) and ``np.digitize``
against the lower 20 edges, so a column's maximum lands in bin 20.
``mutual_info`` is sklearn's ``mutual_info_score`` (natural log, from the
contingency table) for every pair of a code column and a factor column at
once: one ``bincount`` over ``(pair, factor value, bin)``.
"""

from __future__ import annotations

import torch

BINS = 20


def histogram_edges(z: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """[n, D] -> [D, bins + 1] edges per column, as ``np.histogram(col,
    bins)[1]`` computes them: ``linspace`` in the column's dtype from its
    min to its max."""
    lo, hi = z.amin(0), z.amax(0)
    flat = lo == hi
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    delta = hi - lo
    step = delta / bins
    ar = torch.arange(bins + 1, dtype=z.dtype, device=z.device)[None]
    # numpy's linspace multiplies by delta / div, or (for a step that
    # underflows to 0) divides by div first
    y = torch.where(step[:, None] == 0, ar / bins * delta[:, None],
                    ar * step[:, None]) + lo[:, None]
    y[:, -1] = hi
    return y


def discretize(z: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """[n, D] codes -> [n, D] int64 bin ids in 1..``bins``."""
    edges = histogram_edges(z, bins)[:, :-1].contiguous()
    return torch.searchsorted(edges, z.t().contiguous(), right=True).t()


def mutual_info(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, A] and [n, B] integer label columns -> [A, B] float64 mutual
    information in nats, ``sklearn.metrics.mutual_info_score(a[:, i],
    b[:, j])`` for every pair: per-term values below float64's eps are
    zeroed and the sum clipped at 0, and a pair where either column holds
    one label only gives 0."""
    # from 0 per column; values no sample takes only add empty rows
    a, b = a.long() - a.long().amin(0), b.long() - b.long().amin(0)
    n, A = a.shape
    B = b.shape[1]
    ka = int(a.max()) + 1 if n else 1
    kb = int(b.max()) + 1 if n else 1
    pair = torch.arange(A * B, device=a.device).view(A, B)
    idx = ((pair[None] * ka + a[:, :, None]) * kb + b[:, None, :])
    counts = torch.bincount(idx.reshape(-1), minlength=A * B * ka * kb)
    c = counts.view(A, B, ka, kb).double()
    pi, pj = c.sum(3, keepdim=True), c.sum(2, keepdim=True)
    total = float(n)
    nz = c > 0
    safe = torch.where(nz, c, torch.ones_like(c))
    outer = torch.where(nz, pi * pj, torch.ones_like(c))
    log_n = torch.log(torch.tensor(total, dtype=torch.float64,
                                   device=c.device))
    frac = safe / total
    term = (frac * (torch.log(safe) - log_n)
            + frac * (-torch.log(outer) + log_n + log_n))
    term = torch.where(nz & (term.abs() >= torch.finfo(torch.float64).eps),
                       term, torch.zeros_like(term))
    mi = term.sum((2, 3)).clamp_min(0.0)
    single = ((pi > 0).sum((2, 3)) == 1) | ((pj > 0).sum((2, 3)) == 1)
    return torch.where(single, torch.zeros_like(mi), mi)
