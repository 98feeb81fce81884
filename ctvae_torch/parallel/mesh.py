"""Data parallelism over ``torch.distributed`` ranks.

Counterpart of ``ctvae_tpu/parallel/mesh.py``. There one process stands
for one host and a jitted step runs SPMD over the global batch; here one
rank (one process per card, as ``torchrun`` launches them) stands for one
such host. Each rank's loader yields its ``train_batch_size`` rows of a
global batch of ``train_batch_size x world`` rows
(``data/transition.py``), and the train step makes the results those of
one process on the global batch:

- every random draw is drawn at the global shape from the generator that
  every rank holds in lockstep, and the rank keeps its rows
  (``models/base.py::ShardedDraws``);
- the gradients are summed over the ranks in one flattened bucket per
  dtype and divided by the world (``all_reduce_grads``): each rank's loss
  is a mean over its rows, so this is the gradient of the global mean;
- BatchNorm normalises with the global mean and variance, the EMA
  codebook folds in the global counts and sums, and the codebook
  perplexity counts the global codes (``batch_group()`` inside the step,
  set by ``batch_parallel``);
- the step's scalars are the ranks' means (``all_mean``).

The mesh keeps the JAX axis names and order: ``(data, model)`` and, with
``dcn_replicas``, ``(replica, data, model)``, ranks reshaped replica-major.
The batch is split over every axis but ``model``, whose size is 1 here
(``model_axis > 1``, FSDP and sequence parallelism are refused by the
trainer: ROADMAP A8), so the batch's group is the whole world.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"   # across slices (DCN) on a hybrid mesh

#: the group the batch of the running step is split over (``batch_parallel``)
_BATCH_GROUP: Optional[Any] = None


def init_distributed(backend: Optional[str] = None, *,
                     device: Optional[torch.device] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 600.0):
    """Bring up the default process group and return it: NCCL for a CUDA
    ``device``, gloo for the CPU, or ``backend`` where the caller names
    one (gloo also takes CUDA tensors: two ranks on one card). Without
    ``init_method`` the group reads ``torchrun``'s environment
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``). A group
    that does not come up raises; nothing drops to a single process."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if backend is None:
        device = torch.device(device) if device is not None else None
        backend = "nccl" if device is not None and device.type == "cuda" \
            else "gloo"
    kwargs: Dict[str, Any] = {}
    if backend == "nccl" and device is not None:
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.group.WORLD


def launched_by_torchrun() -> bool:
    """``torchrun`` (``python -m torch.distributed.run``) set this
    process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, or no group: the process that writes checkpoints, samples
    and logs."""
    return rank() == 0


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh():
    """``DeviceMesh`` ``(data, model)`` over every rank of the default
    group, the model axis of size 1."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(world_size()).reshape(-1, 1)
    return DeviceMesh(_mesh_device_type(), ranks,
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_hybrid_mesh(dcn_replicas: int):
    """``DeviceMesh`` ``(replica, data, model)``: the ranks reshaped
    replica-major, as the JAX package reshapes devices without slice
    topology, the model axis of size 1. The batch is split over (replica,
    data) jointly."""
    from torch.distributed.device_mesh import DeviceMesh
    n = world_size()
    if dcn_replicas < 1 or n % dcn_replicas:
        raise ValueError(f"dcn_replicas {dcn_replicas} does not divide the "
                         f"world of {n} ranks")
    ranks = torch.arange(n).reshape(dcn_replicas, n // dcn_replicas, 1)
    return DeviceMesh(_mesh_device_type(), ranks,
                      mesh_dim_names=(REPLICA_AXIS, DATA_AXIS, MODEL_AXIS))


def mesh_batch_group(mesh):
    """The group the batch is split over: every axis but ``model``, whose
    size is 1, so every rank of the mesh, which spans the world: the
    default group."""
    if mesh.size() != world_size():
        raise NotImplementedError("a mesh over part of the world is not "
                                  "ported yet (ROADMAP A8)")
    return dist.group.WORLD


# --- the running step's group ----------------------------------------------

@contextlib.contextmanager
def batch_parallel(group) -> Iterator[None]:
    """Inside, ``batch_group()`` is ``group`` (None: a single process): the
    train and eval steps set it around their forward, so the layers that
    reduce over the batch (BatchNorm, the EMA codebook, the perplexity)
    reduce over the global one. Outside a step (serving, samples) they
    see their own rows."""
    global _BATCH_GROUP
    previous, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = previous


def batch_group():
    """The group of the running step's batch, or None."""
    return _BATCH_GROUP


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _comm_device(group, like: Optional[torch.device] = None
                 ) -> torch.device:
    """Where a collective's tensors must lie: the current card for NCCL,
    else ``like`` (gloo takes CPU and CUDA tensors) or the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return like if like is not None else torch.device("cpu")


# --- collectives of the step -----------------------------------------------

def _means(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors' means over the group's ranks: one flattened bucket per
    dtype, summed, then divided by the world (at a world of 1 exactly the
    input)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        bucket = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
        bucket.div_(group_size(group))
        parts = torch.split(bucket, [tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view_as(tensors[i])
    return out


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> int:
    """Every ``p.grad`` replaced, in place, by its mean over the group's
    ranks (``_means``). Returns the bytes reduced."""
    grads = [p.grad for p in params if p.grad is not None]
    for g, m in zip(grads, _means(grads, group)):
        g.copy_(m)
    return sum(g.numel() * g.element_size() for g in grads)


def all_mean(values: Dict[str, torch.Tensor], group
             ) -> Dict[str, torch.Tensor]:
    """Each floating tensor of ``values`` averaged over the group's ranks
    (``_means``); other entries as they are."""
    keys = [k for k, v in values.items() if v.is_floating_point()]
    return {**values, **dict(zip(keys, _means([values[k] for k in keys],
                                               group)))}


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks (a new tensor; no gradient)."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of one shape stacked along dim 0 in rank order
    (no gradient). Made by a sum of zero-padded copies, which every
    backend takes on the CPU and the card (gloo gathers no CUDA tensors)
    and a CUDA graph can capture."""
    n, r = group_size(group), group_rank(group)
    out = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
    out[r * t.shape[0]:(r + 1) * t.shape[0]].copy_(t)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_autograd(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, with the gradient of the sum
    (each rank's input gets the sum of the ranks' output gradients)."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def global_any(flag: bool, group) -> bool:
    """``flag`` ORed over the group's ranks (the loop's stop request: a
    lone rank leaving the loop would strand the others in a collective)."""
    t = torch.tensor([1.0 if flag else 0.0], device=_comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)


# --- the batch and the state -----------------------------------------------

def local_rows(batch: Dict[str, Any], group) -> Dict[str, Any]:
    """The rank's rows of a global batch (rank r of n: rows r B to (r + 1)
    B of n B), as the loaders give them."""
    n, r = group_size(group), group_rank(group)
    out = {}
    for k, v in batch.items():
        if isinstance(v, str):
            out[k] = v
            continue
        if len(v) % n:
            raise ValueError(f"{k}: {len(v)} rows do not split over {n} "
                             f"ranks")
        b = len(v) // n
        out[k] = v[r * b:(r + 1) * b]
    return out


def shard_batch(batch: Dict[str, Any], device: torch.device
                ) -> Dict[str, Any]:
    """The rank's batch on ``device``: the loader's batch is already the
    rank's slice of the global one (``data/transition.py``), so this moves
    it to the device (``data/prefetch.py``); ``local_rows`` takes the
    rank's rows of a global batch."""
    from ..data.prefetch import to_device
    return to_device(batch, device)


def _tensors(module: torch.nn.Module) -> Iterator[torch.Tensor]:
    yield from module.parameters()
    yield from module.buffers()


def put_replicated(module: torch.nn.Module, group,
                   generator: Optional[torch.Generator] = None) -> None:
    """Broadcast every parameter and buffer of ``module`` (and the state
    of ``generator``) from rank 0 of ``group``, in place, then assert that
    the ranks agree: each tensor's float64 sum and the generator's state
    equal their maxima over the ranks."""
    if group is None:
        return
    dev = None
    with torch.no_grad():
        for t in _tensors(module):
            dev = _comm_device(group, t.device)
            if t.device == dev:
                dist.broadcast(t.data, src=0, group=group)
            else:
                tmp = t.data.to(dev)
                dist.broadcast(tmp, src=0, group=group)
                t.data.copy_(tmp)
        sums = torch.stack([t.detach().double().sum()
                            for t in _tensors(module)])
        if generator is not None:
            state = generator.get_state()
            cdev = _comm_device(group)
            g = state.to(cdev)
            dist.broadcast(g, src=0, group=group)
            generator.set_state(g.cpu())
            sums = torch.cat([sums, state.double().to(sums.device)])
        sums = sums.to(_comm_device(group, sums.device))
        hi = sums.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        if not torch.equal(hi, sums):
            raise RuntimeError("the ranks' parameters, buffers or "
                               "generators differ after the broadcast")


def destroy() -> None:
    """Tear the default group down, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["DATA_AXIS", "MODEL_AXIS", "REPLICA_AXIS", "all_gather_rows",
           "all_mean", "all_reduce_autograd", "all_reduce_grads", "all_sum",
           "batch_group", "batch_parallel", "destroy", "global_any",
           "group_rank", "group_size", "init_distributed", "is_primary",
           "launched_by_torchrun", "local_rows", "make_hybrid_mesh",
           "make_mesh", "mesh_batch_group", "put_replicated", "rank",
           "shard_batch", "world_size"]
