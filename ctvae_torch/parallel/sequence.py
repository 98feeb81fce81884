"""Sequence parallelism over ``torch.distributed`` ranks.

Counterpart of the sequence-parallel section of
``ctvae_tpu/parallel/mesh.py`` (``shard_dim``). The CT model's O(S^2)
domains, the discoverer's pairwise scores [B, S, S] and the GATv2
attention [B, S, T, H], are split along their target (column) axis over
the ranks of the mesh's ``model`` axis: each rank of a model group runs
the kernels on its own block of targets against every source, and the
blocks are gathered along the target axis. The ranks of a model group
hold the same rows (``mesh.py``), so everything outside the split region
is computed alike on each of them, and the result is that of one process.

A region has three kinds of edges (Megatron's sequence-parallel
regions):

- ``enter``: a tensor or parameter that the whole region reads (the
  sources' features, the layers' weights). Forward: itself. Backward:
  the sum over the model group, since each rank's gradient holds only
  the share of its own targets. A tensor that the region reads and that
  is not entered gets a gradient that is off by a factor of up to the
  group's size, while every forward value stays right;
- ``scatter_targets``: a tensor of which the region reads only the
  rank's block (the adjacency's columns). Forward: the block. Backward:
  the blocks' gradients gathered (``gather_targets``);
- ``gather_targets``: the region's output. Forward: the blocks gathered
  along the target axis. Backward: the rank's block of the gradient,
  which every rank of the group computed alike downstream.

The blocks: T targets over m ranks give rank r ``T // m`` targets, one
more for the first ``T % m`` ranks (T = 65 at m = 2: 33 + 32), so block
sizes differ by at most one. A collective takes equal shapes, so the
shorter blocks are padded to the first one's size and trimmed after.
Outside ``model_parallel``, or with a model group of one rank,
``split_group`` is None and a model built with ``seq_axis`` runs as
without it, as JAX's ``shard_dim`` is a no-op outside a mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, group_rank, group_size, model_group


def target_blocks(T: int, m: int) -> List[Tuple[int, int]]:
    """The (start, stop) of each of ``m`` ranks' blocks of ``T``
    targets, in rank order: ``T // m`` each, one more for the first
    ``T % m``. Raises where a block would be empty."""
    if m < 1 or T < m:
        raise ValueError(f"{T} targets do not split over {m} ranks")
    out, start = [], 0
    for r in range(m):
        stop = start + T // m + (r < T % m)
        out.append((start, stop))
        start = stop
    return out


def target_block(T: int, group) -> Tuple[int, int]:
    """This rank's (start, stop) of ``T`` targets over ``group``."""
    return target_blocks(T, group_size(group))[group_rank(group)]


def split_group(seq_axis: Optional[str]):
    """The group a model built with ``seq_axis`` splits its targets over:
    the running step's model group (``model_parallel``) where
    ``seq_axis`` names the mesh's ``model`` axis and the group has more
    than one rank, else None (no split)."""
    group = model_group()
    if seq_axis != MODEL_AXIS or group_size(group) <= 1:
        return None
    return group


def _gather_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of one shape stacked along dim 0 in rank order:
    an all-gather, but over gloo on a card (gloo gathers no CUDA
    tensors) a sum of zero-padded copies, which is exact."""
    m, r = group_size(group), group_rank(group)
    if t.is_cuda and dist.get_backend(group) != "nccl":
        out = t.new_zeros((m * t.shape[0],) + tuple(t.shape[1:]))
        out[r * t.shape[0]:(r + 1) * t.shape[0]] = t
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    out = t.new_empty((m * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _gather(block: torch.Tensor, dim: int, T: int, group) -> torch.Tensor:
    """The ranks' blocks of ``T`` targets along ``dim``, gathered."""
    blocks = target_blocks(T, group_size(group))
    size = blocks[0][1] - blocks[0][0]
    t = block.movedim(dim, 0)
    if t.shape[0] < size:
        t = torch.cat([t, t.new_zeros((size - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    full = _gather_dim0(t.contiguous(), group)
    parts = [full[i * size:i * size + (b - a)]
             for i, (a, b) in enumerate(blocks)]
    return torch.cat(parts).movedim(0, dim).contiguous()


class _GatherTargets(torch.autograd.Function):

    @staticmethod
    def forward(ctx, block, dim, T, group):
        ctx.dim, ctx.group = dim, group
        ctx.lo, ctx.hi = target_block(T, group)
        return _gather(block, dim, T, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo).contiguous(),
                None, None, None)


class _ScatterTargets(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.T = dim, group, t.shape[dim]
        lo, hi = target_block(ctx.T, group)
        return t.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.T, ctx.group), None, None


class _Enter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *sum_grads(grads, ctx.group))


def sum_grads(grads, group) -> List[Optional[torch.Tensor]]:
    """Each of ``grads`` (None stays None) summed over ``group`` in one
    float32 bucket per device, each cast back to its dtype once."""
    live = [i for i, g in enumerate(grads) if g is not None]
    out: List[Optional[torch.Tensor]] = list(grads)
    by_device: Dict[torch.device, List[int]] = {}
    for i in live:
        by_device.setdefault(grads[i].device, []).append(i)
    for idx in by_device.values():
        bucket = torch.cat([grads[i].reshape(-1).to(torch.promote_types(
            grads[i].dtype, torch.float32)) for i in idx])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
        parts = torch.split(bucket, [grads[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view_as(grads[i]).to(grads[i].dtype)
    return out


def enter(group, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tensors`` as they are, whose gradients are summed over ``group``
    (one all-reduce for all of them): the inputs and parameters that a
    split region reads in full."""
    return _Enter.apply(group, *tensors)


def scatter_targets(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``t``'s targets along ``dim``; the blocks'
    gradients are gathered in the backward."""
    return _ScatterTargets.apply(t, dim, group)


def gather_targets(block: torch.Tensor, dim: int, T: int, group
                   ) -> torch.Tensor:
    """The ranks' blocks of ``T`` targets along ``dim``, gathered in rank
    order; the backward keeps this rank's block of the gradient."""
    return _GatherTargets.apply(block, dim, T, group)


__all__ = ["enter", "gather_targets", "scatter_targets", "split_group",
           "sum_grads", "target_block", "target_blocks"]
