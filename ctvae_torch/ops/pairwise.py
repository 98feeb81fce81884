"""Pairwise edge scoring for causal graph discovery (plain PyTorch).

Counterpart of ``ctvae_tpu/ops/pairwise.py``. The discoverer MLP on the
concatenated pair factors as ``W [x_s || x_t] = Wl x_s + Wr x_t``, so the
caller projects once and only the broadcast-add + LeakyReLU + contraction
runs per pair. On CUDA tensors the per-pair work runs in the kernel of
``ops/pairwise_flash.py``; the plain form here is its CPU path and the
reference it is checked against.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bh(p: torch.Tensor) -> torch.Tensor:
    """[H] stays (broadcasts) or [B, H] -> [B, 1, 1, H] against [B,S,T,H]."""
    return p[:, None, None, :] if p.ndim == 2 else p


def _b(p: torch.Tensor) -> torch.Tensor:
    """A scalar stays; [B] -> [B, 1, 1] against [B, S, T]."""
    return p[:, None, None] if p.ndim == 1 else p


def fused_pairwise_scores(xl: torch.Tensor, xr: torch.Tensor,
                          w2: torch.Tensor, b1: torch.Tensor,
                          b2: torch.Tensor, ns: float) -> torch.Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` -> [B, S, T].

    xl [B,S,H], xr [B,T,H], w2 [H] or [B,H], b1 [H] or [B,H], b2 scalar or
    [B]. Materialises the [B, S, T, H] domain: the plain version."""
    pre = xl[:, :, None, :] + xr[:, None, :, :] + _bh(b1)
    act = torch.where(pre >= 0, pre, ns * pre)
    z = torch.sum(act * _bh(w2), dim=-1) + _b(b2)
    return torch.sigmoid(z)


def pairwise_mlp_scores(x_left: torch.Tensor, x_right: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, b1: torch.Tensor,
                        negative_slope: float = 0.01,
                        block_rows: Optional[int] = None) -> torch.Tensor:
    """Scores for all ordered pairs, [B, S, S].

    x_left [B, S, H] = X @ Wl (row element), x_right [B, S, H] = X @ Wr
    (column element); w2 [H] or [B, H]; b2 scalar or [B]; b1 [H] or
    [B, H]. Shared params stay unbroadcast (the kernel reads them with
    batch stride 0)."""
    if block_rows is not None:
        raise NotImplementedError("pairwise_block_rows is not ported yet")
    from .pairwise_flash import flash_pairwise
    return flash_pairwise(x_left, x_right, w2, b1, b2, negative_slope)
