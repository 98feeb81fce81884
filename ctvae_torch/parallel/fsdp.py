"""Fully sharded data parallelism (ZeRO-3) over ``torch.distributed``
ranks, by hand.

Counterpart of ``exp_params.sharding: fsdp`` in the JAX package
(``ctvae_tpu/parallel/mesh.py::fsdp_shardings`` and the trainer's
``shard_params_fsdp`` / ``pin_state_shardings``), where XLA inserts the
all-gathers and reduce-scatters from sharding annotations. Here
``FSDP`` does them around the data-parallel step of ``parallel/
mesh.py``:

- each rank owns one slice of every parameter that ``fsdp_plan`` splits
  (the slice ``r`` of ``n`` along the planned dim, ``n`` the data
  group's size) as a parameter of its own (``shards``); the optimizers
  take the slices in the parameters' places, so Adam's moments exist for
  the slice alone (``shard_of``);
- ``gather`` all-gathers the slices into the module's parameters before
  the step's forward (NCCL's ``all_gather_into_tensor``; over gloo, which
  gathers no CUDA tensors, a sum of zero-padded copies), one flat bucket
  per dtype;
- ``reduce_grads`` after the backward reduce-scatters each split
  parameter's gradient to its owner (a mean over the data group; over
  gloo an all-reduce of the bucket whose rank's row is kept), then, on a
  hybrid mesh, averages the slices over the replica group; the
  replicated parameters keep the bucketed all-reduce over the batch's
  group (``all_reduce_grads``);
- ``release`` drops the full parameters and their gradients, so between
  steps only the slices, the replicated parameters and the buffers stay
  resident.

The norms of the step (``grad_norm``, the clip, ``watch_gradients``)
are global: the squares of the slices summed over the data group plus
the replicated parameters' once, each leaf's term in its dtype and in
the order one process adds them (``sq_sums``, ``norm_fn``), so with
nothing split a bfloat16 model's norms are one process's bit for bit.
A checkpoint holds the full state (``full_optimizer_state``, the
model's ``state_dict`` inside ``full()``), so one process, DP ranks and
FSDP ranks restore each other's; ``load_full`` / ``load_optimizer_state`` take a full state back
into the slices. The full parameters are plain tensors swapped into
``Parameter.data`` for the span of a step, so a CUDA graph captures the
gather, the step and the release together (NCCL).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import (FSDP_MIN_SIZE, all_reduce_grads, fsdp_plan, group_rank,
                   group_size)


def _flat_gather(local: torch.Tensor, group) -> torch.Tensor:
    """[n, k]: row r the rank r's flat ``local`` [k]."""
    n, r = group_size(group), group_rank(group)
    if dist.get_backend(group) == "nccl":
        out = local.new_empty((n * local.numel(),))
        dist.all_gather_into_tensor(out, local, group=group)
        return out.view(n, -1)
    out = local.new_zeros((n, local.numel()))
    out[r].copy_(local)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _flat_reduce_scatter(packed: torch.Tensor, group) -> torch.Tensor:
    """The rank's row of ``packed`` [n, k] summed over the ranks: [k]."""
    r = group_rank(group)
    if dist.get_backend(group) == "nccl":
        out = packed.new_empty((packed.shape[1],))
        dist.reduce_scatter_tensor(out, packed.reshape(-1),
                                   op=dist.ReduceOp.SUM, group=group)
        return out
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    return packed[r]


class FSDP:
    """The ZeRO-3 state of ``model`` over ``data_group`` (and, on a hybrid
    mesh, ``replica_group``): its split parameters' slices and the
    collectives of the step around them (see the module doc). Built from
    full parameters equal on every rank (after ``put_replicated``); the
    full parameters are released at once."""

    def __init__(self, model: nn.Module, plan: Dict[str, Optional[int]],
                 data_group, replica_group=None):
        self.data_group, self.replica_group = data_group, replica_group
        self.n, self.rank = group_size(data_group), group_rank(data_group)
        self.params = dict(model.named_parameters())
        self.axes = {k: a for k, a in plan.items() if a is not None}
        self.shapes = {k: tuple(self.params[k].shape) for k in self.axes}
        self._name = {id(p): k for k, p in self.params.items()}
        self.shards: Dict[str, nn.Parameter] = {}
        with torch.no_grad():
            for k, axis in self.axes.items():
                p = self.params[k]
                self.shards[k] = nn.Parameter(
                    self._slice(p.detach(), k).clone(),
                    requires_grad=p.requires_grad)
        self._shard_name = {id(s): k for k, s in self.shards.items()}
        self.gathered = True
        self.release()

    # -- layout ----------------------------------------------------------

    def _slice(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's slice of a full tensor of parameter ``name``."""
        return full.chunk(self.n, dim=self.axes[name])[self.rank] \
            .contiguous()

    def gather_full(self, items: List[Tuple[str, torch.Tensor]]
                    ) -> List[torch.Tensor]:
        """(split parameter's name, slice-shaped tensor: a value, a
        gradient, an Adam moment) -> the full tensors, in order, one
        all-gather per dtype (a collective: every rank calls it with the
        same names in the same order)."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, (_, t) in enumerate(items):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            local = torch.cat([items[i][1].detach().reshape(-1)
                               for i in idx])
            rows = _flat_gather(local, self.data_group)
            off = 0
            for i in idx:
                k, t = items[i]
                m = t.numel()
                out[i] = torch.cat([rows[r, off:off + m].view(t.shape)
                                    for r in range(self.n)],
                                   dim=self.axes[k])
                off += m
        return out

    def shard_of(self, p: nn.Parameter) -> nn.Parameter:
        """What an optimizer takes in ``p``'s place: its slice when split,
        else ``p``."""
        k = self._name.get(id(p))
        return self.shards[k] if k in self.shards else p

    # -- the step --------------------------------------------------------

    @torch.no_grad()
    def gather(self) -> bool:
        """All-gather the slices into the module's parameters (no-op when
        they are there). Returns whether it gathered."""
        if self.gathered:
            return False
        full = self.gather_full(list(self.shards.items()))
        for k, t in zip(self.shards, full):
            self.params[k].data = t
        self.gathered = True
        return True

    def release(self) -> None:
        """Drop the full split parameters and their gradients (each
        ``Parameter.data`` becomes an empty tensor of its dtype and
        device)."""
        for k in self.shards:
            p = self.params[k]
            p.grad = None
            p.data = p.data.new_empty((0,))
        self.gathered = False

    @contextlib.contextmanager
    def full(self) -> Iterator[None]:
        """Inside, the module holds its full parameters (gathered on entry
        unless they are there, released on exit if gathered here)."""
        gathered = self.gather()
        try:
            yield
        finally:
            if gathered:
                self.release()

    def reduce_grads(self, batch_group) -> None:
        """After the backward: each split parameter's gradient reduced to
        the rank's slice (the mean over the data group, then over the
        replica group) in its slice's ``grad``; the replicated
        parameters' gradients averaged over ``batch_group``
        (``all_reduce_grads``)."""
        named = [(k, self.params[k].grad) for k in self.shards]
        for s in self.shards.values():
            s.grad = None
        with torch.no_grad():
            by_dtype: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
            for k, g in named:
                if g is not None:
                    by_dtype.setdefault(g.dtype, []).append((k, g))
            for items in by_dtype.values():
                chunks = [g.chunk(self.n, dim=self.axes[k])
                          for k, g in items]
                packed = torch.cat([c[r].reshape(-1) for r in range(self.n)
                                    for c in chunks]).view(self.n, -1)
                mine = _flat_reduce_scatter(packed, self.data_group)
                mine.div_(self.n)
                if group_size(self.replica_group) > 1:
                    dist.all_reduce(mine, op=dist.ReduceOp.SUM,
                                    group=self.replica_group)
                    mine.div_(group_size(self.replica_group))
                off = 0
                for k, g in items:
                    s = self.shards[k]
                    s.grad = mine[off:off + s.numel()].view(s.shape)
                    off += s.numel()
        for k in self.shards:
            self.params[k].grad = None
        rest = [p for k, p in self.params.items() if k not in self.shards]
        all_reduce_grads(rest, batch_group)

    def _leaf_terms(self, groups: Iterable[Iterable[torch.Tensor]],
                    grads: bool, split_term, finish, rep_term
                    ) -> List[List[torch.Tensor]]:
        """For each group of parameters (the module's or the optimizers'
        slices), one 0-d term per parameter with a value (``grads``: its
        full gradient, else the parameter; one without a gradient is
        left out), in the group's order: ``rep_term(t)`` of a replicated
        one, ``finish(sum, dtype)`` of a split one, where ``sum`` is its
        slices' float32 ``split_term`` summed over the data group (one
        all-reduce for all of them)."""
        slots, partials = [], []
        for ps in groups:
            row = []
            for p in ps:
                k = self._shard_name.get(id(p), self._name.get(id(p)))
                split = k in self.shards
                t = self.shards[k] if split else p
                v = t.grad if grads else t
                if v is None:
                    continue
                v = v.detach()
                if split:
                    row.append((len(partials), v.dtype))
                    partials.append(split_term(v))
                else:
                    row.append(rep_term(v))
            slots.append(row)
        if partials:
            reduced = torch.stack(partials)
            dist.all_reduce(reduced, op=dist.ReduceOp.SUM,
                            group=self.data_group)
        return [[finish(reduced[x[0]], x[1]) if isinstance(x, tuple) else x
                 for x in row] for row in slots]

    def sq_sums(self, groups: Iterable[Iterable[torch.Tensor]],
                grads: bool) -> List[torch.Tensor]:
        """For each group of parameters the sum of squares of the full
        tensors' gradients (``grads``) or values, as
        ``training/state.py::global_norm`` sums one process's: per
        parameter ``sum(square(t))`` in its dtype (a split one's slices
        summed in float32 over the data group, then rounded once to its
        dtype, as a reduction of the whole leaf rounds), added in order
        from Python's 0, so two bfloat16 leaves in a row add in bfloat16
        as there. With nothing split this is one process's sum bit for
        bit. A parameter without a gradient adds nothing; a group with
        nothing to add gives a zero of its first parameter's dtype."""
        groups = [list(ps) for ps in groups]
        terms = self._leaf_terms(
            groups, grads,
            lambda v: torch.sum(torch.square(v), dtype=torch.float32),
            lambda total, dtype: total.to(dtype),
            lambda v: torch.sum(torch.square(v)))
        return [sum(ts) if ts else ps[0].new_zeros(())
                for ps, ts in zip(groups, terms)]

    def norm_fn(self, params: List[torch.Tensor]):
        """The global gradient norm over ``params`` (an optimizer's) as
        ``torch.nn.utils.clip_grad_norm_`` takes it for its clip, or None
        when none of them is split: each parameter's norm in its dtype (a
        split one's from its slices' float32 squares summed over the data
        group), grouped by dtype in order of first appearance, and the
        2-norm of them all in float32."""
        if not any(id(p) in self._shard_name for p in params):
            return None

        def norm() -> torch.Tensor:
            (norms,) = self._leaf_terms(
                [params], True,
                lambda v: torch.sum(torch.square(v.float())),
                lambda total, dtype: torch.sqrt(total).to(dtype),
                lambda v: torch._foreach_norm([v])[0])
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for n in norms:
                by_dtype.setdefault(n.dtype, []).append(n)
            ordered = [n for ns in by_dtype.values() for n in ns]
            return torch.linalg.vector_norm(torch.stack(ordered))
        return norm

    # -- full state ------------------------------------------------------

    def resident_bytes(self, optimizers: Iterable[Any] = ()) -> int:
        """Bytes of the parameters (slices and replicated) and of the
        optimizers' Adam moments this rank holds now."""
        ts = [s for s in self.shards.values()] + [
            p for k, p in self.params.items() if k not in self.shards]
        for opt in optimizers:
            for st in opt.adam.state.values():
                ts += [v for key, v in st.items()
                       if key in ("exp_avg", "exp_avg_sq")]
        return sum(t.numel() * t.element_size() for t in ts)

    @torch.no_grad()
    def load_full(self) -> None:
        """Copy the module's full parameters (put there inside
        ``materialized``) into the slices."""
        for k, s in self.shards.items():
            s.copy_(self._slice(self.params[k].data, k))

    @contextlib.contextmanager
    def materialized(self) -> Iterator[None]:
        """Inside, the module's split parameters are full-size tensors of
        unspecified values (no collective), for a load of a full state
        that ``load_full`` then slices; released on exit."""
        if self.gathered:
            raise RuntimeError("the full parameters are already there")
        for k, shape in self.shapes.items():
            s = self.shards[k]
            self.params[k].data = s.new_empty(shape)
        self.gathered = True
        try:
            yield
        finally:
            self.release()

    def full_optimizer_state(self, opt) -> Dict[str, Any]:
        """``opt.state_dict()`` with every slice-shaped Adam moment and
        accumulated gradient gathered to its parameter's full shape: the
        state of one process (a collective)."""
        sd = opt.state_dict()
        adam = dict(sd["adam"])
        state = {i: dict(st) for i, st in adam["state"].items()}
        where, items = [], []
        for i, p in enumerate(opt.params):
            k = self._shard_name.get(id(p))
            if k is None:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state.get(i, {}):
                    where.append((i, key))
                    items.append((k, state[i][key]))
            if sd["acc"] is not None:
                where.append((i, "acc"))
                items.append((k, sd["acc"][i]))
        acc = None if sd["acc"] is None else list(sd["acc"])
        for (i, key), full in zip(where, self.gather_full(items)):
            if key == "acc":
                acc[i] = full
            else:
                state[i][key] = full
        adam["state"] = state
        return {**sd, "adam": adam, "acc": acc}

    def load_optimizer_state(self, opt, state: Dict[str, Any]) -> None:
        """Load a full optimizer state (``full_optimizer_state``'s, or one
        process's) into ``opt``, whose split parameters are slices: each
        such moment and accumulated gradient sliced to the rank's part."""
        adam = dict(state["adam"])
        st = {i: dict(v) for i, v in adam["state"].items()}
        acc = None if state["acc"] is None else list(state["acc"])
        for i, p in enumerate(opt.params):
            k = self._shard_name.get(id(p))
            if k is None:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st.get(i, {}):
                    st[i][key] = self._slice(st[i][key], k)
            if acc is not None:
                acc[i] = self._slice(acc[i], k)
        adam["state"] = st
        opt.load_state_dict({**state, "adam": adam, "acc": acc})


def fully_shard(model: nn.Module, data_group, replica_group=None,
                min_size: int = FSDP_MIN_SIZE) -> FSDP:
    """``FSDP`` of ``model`` with ``fsdp_plan`` at the data group's size:
    call it on every rank after the parameters were made equal
    (``put_replicated``), and build the optimizers through
    ``FSDP.shard_of`` after it."""
    return FSDP(model, fsdp_plan(model, group_size(data_group), min_size),
                data_group, replica_group)


__all__ = ["FSDP", "fully_shard"]
