"""Pairwise edge scoring for causal graph discovery (plain PyTorch).

Counterpart of ``ctvae_tpu/ops/pairwise.py``. The discoverer MLP on the
concatenated pair factors as ``W [x_s || x_t] = Wl x_s + Wr x_t``, so the
caller projects once and only the broadcast-add + LeakyReLU + contraction
runs per pair. On CUDA tensors the per-pair work runs in the kernels of
``ops/pairwise_flash.py`` (forward and backward); the plain form here, with
its autograd, is their CPU path and the reference they are checked
against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sequence import gather_targets, split_group, target_block
from .common import upcast32


def _bh(p: torch.Tensor) -> torch.Tensor:
    """[H] stays (broadcasts) or [B, H] -> [B, 1, 1, H] against [B,S,T,H]."""
    return p[:, None, None, :] if p.ndim == 2 else p


def _b(p: torch.Tensor) -> torch.Tensor:
    """A scalar stays; [B] -> [B, 1, 1] against [B, S, T]."""
    return p[:, None, None] if p.ndim == 1 else p


def pairwise_logits(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                    b1: torch.Tensor, b2: torch.Tensor, ns: float
                    ) -> torch.Tensor:
    """``z = sum_h leaky(xl_s + xr_t + b1) * w2 + b2`` [B, S, T], in at
    least float32 (every input upcast first, as the JAX kernel loads
    them)."""
    xl, xr, w2, b1, b2 = map(upcast32, (xl, xr, w2, b1, b2))
    pre = xl[:, :, None, :] + xr[:, None, :, :] + _bh(b1)
    act = torch.where(pre >= 0, pre, ns * pre)
    return torch.sum(act * _bh(w2), dim=-1) + _b(b2)


def fused_pairwise_scores(xl: torch.Tensor, xr: torch.Tensor,
                          w2: torch.Tensor, b1: torch.Tensor,
                          b2: torch.Tensor, ns: float) -> torch.Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` -> [B, S, T].

    xl [B,S,H], xr [B,T,H], w2 [H] or [B,H], b1 [H] or [B,H], b2 scalar or
    [B]. Materialises the [B, S, T, H] domain: the plain version. Computed
    in float32, returned in xl's dtype (bfloat16 scores of bfloat16
    inputs, as the JAX kernel writes them)."""
    return torch.sigmoid(pairwise_logits(xl, xr, w2, b1, b2, ns)).to(
        xl.dtype)


def column_group(S: int, block_rows: Optional[int], seq_axis):
    """The group ``pairwise_mlp_scores`` splits its columns over:
    ``seq_axis`` inside a model group (``parallel/sequence.py``), but not
    on the ``block_rows`` path, which JAX leaves unsharded; else None."""
    if block_rows is not None and block_rows < S:
        return None
    return split_group(seq_axis)


def pairwise_mlp_scores(x_left: torch.Tensor, x_right: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, b1: torch.Tensor,
                        negative_slope: float = 0.01,
                        block_rows: Optional[int] = None,
                        seq_axis=None) -> torch.Tensor:
    """Scores for all ordered pairs, [B, S, S].

    x_left [B, S, H] = X @ Wl (row element), x_right [B, S, H] = X @ Wr
    (column element); w2 [H] or [B, H]; b2 scalar or [B]; b1 [H] or
    [B, H]. Shared params stay unbroadcast (the kernel reads them with
    batch stride 0).

    ``block_rows`` bounds the plain version's [B, C, S, H] workspace as
    JAX's ``pairwise_block_rows`` does: on CPU tensors the rows go through
    the op ``block_rows`` at a time (rows are independent, so the scores
    are the unchunked ones). The CUDA kernels never build that workspace
    and take all rows in one launch.

    ``seq_axis`` (sequence parallelism) splits the columns over the
    running step's model group (``column_group``): the rank scores its
    block of ``x_right``'s columns and the blocks are gathered along
    dim 2. The gradients of every input are then the block's share: the
    caller enters the region upstream, where the bytes are fewer
    (``models/ct_vae.py`` enters the latent and the discoverer's
    parameters)."""
    from .pairwise_flash import flash_pairwise
    S = x_left.shape[1]
    group = column_group(S, block_rows, seq_axis)
    if group is not None:
        lo, hi = target_block(S, group)
        block = flash_pairwise(x_left, x_right[:, lo:hi].contiguous(), w2,
                               b1, b2, negative_slope)
        return gather_targets(block, 2, S, group)
    if block_rows is None or block_rows >= S or x_left.device.type != "cpu":
        return flash_pairwise(x_left, x_right, w2, b1, b2, negative_slope)
    return torch.cat([flash_pairwise(x_left[:, r:r + block_rows].contiguous(),
                                     x_right, w2, b1, b2, negative_slope)
                      for r in range(0, S, block_rows)], dim=1)
