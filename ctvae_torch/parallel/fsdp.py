"""Fully sharded data parallelism (ZeRO-3) over ``torch.distributed``
ranks, by hand.

Counterpart of ``exp_params.sharding: fsdp`` in the JAX package
(``ctvae_tpu/parallel/mesh.py::fsdp_shardings`` and the trainer's
``shard_params_fsdp`` / ``pin_state_shardings``), where XLA inserts the
all-gathers and reduce-scatters from sharding annotations. Here
``FSDP`` does them around the data-parallel step of ``parallel/
mesh.py``:

- each rank owns one block of every parameter that ``fsdp_plan`` splits
  as a parameter of its own (``shards``): on a mesh with a ``model``
  axis of ``m`` ranks, rank (d, m) of the (data, model) mesh holds block
  m along the planned model dim (JAX's tensor-parallel rules) and,
  inside it, block d of ``n`` along the planned data dim (``n`` the data
  group's size); either dim may be absent. The optimizers take the
  blocks in the parameters' places, so Adam's moments exist for the
  block alone (``shard_of``);
- ``gather`` all-gathers the blocks into the module's parameters before
  the step's forward, over the model group and then over the data group
  (NCCL's ``all_gather_into_tensor``; over gloo, which gathers no CUDA
  tensors, a sum of zero-padded copies), one flat bucket per dtype and
  group;
- ``reduce_grads`` after the backward reduces each split parameter's
  gradient to its owner: the ranks of a model group hold the same rows,
  so each keeps its model block of its own gradient (no sum over the
  model group), reduce-scattered over the data group (a mean; over gloo
  an all-reduce of the bucket whose rank's row is kept; a leaf split
  over ``model`` alone is all-reduced there), then, on a hybrid mesh,
  averaged over the replica group. The replicated parameters keep the
  bucketed all-reduce over the batch's group (``all_reduce_grads``);
  with a model axis their reduced gradients are then broadcast from the
  model group's first rank, so the group's replicated parameters stay
  bit-identical even where two ranks' backwards differ in their last
  bits (the card's eager convolutions without ``cudnn.deterministic``);
  a broadcast copies bits, where a mean of m equal floats need not give
  the value back;
- ``release`` drops the full parameters and their gradients, so between
  steps only the blocks, the replicated parameters and the buffers stay
  resident.

The norms of the step (``grad_norm``, the clip, ``watch_gradients``)
are global: the squares of the blocks summed over the data group and
the model group plus the replicated parameters' once, each leaf's term
in its dtype and in the order one process adds them (``sq_sums``,
``norm_fn``), so with nothing split a bfloat16 model's norms are one
process's bit for bit.
A checkpoint holds the full state (``full_optimizer_state``, the
model's ``state_dict`` inside ``full()``), so one process, DP ranks and
FSDP ranks (with or without a model axis) restore each other's;
``load_full`` / ``load_optimizer_state`` take a full state back into the
blocks. The full parameters are plain tensors swapped into
``Parameter.data`` for the span of a step, so a CUDA graph captures the
gather, the step and the release together (NCCL).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import (FSDP_MIN_SIZE, Split, all_reduce_grads, fsdp_plan,
                   group_rank, group_size)


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


def _broadcast_from_first(tensors: List[torch.Tensor], group) -> None:
    """Each tensor, in place, set to its value on the group's first rank:
    one flat bucket per dtype."""
    src = dist.get_global_rank(group, 0)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(bucket, src=src, group=group)
        for t, part in zip(ts, torch.split(bucket,
                                           [t.numel() for t in ts])):
            t.copy_(part.view_as(t))


class FSDP:
    """The ZeRO-3 state of ``model`` over ``data_group`` (with a model
    axis also ``model_group``, on a hybrid mesh ``replica_group``): its
    split parameters' blocks and the collectives of the step around them
    (see the module doc). ``plan`` is ``fsdp_plan``'s at the groups'
    sizes; ``axes`` / ``model_axes`` name the dim of each parameter split
    over ``data`` / ``model``. Built from full parameters equal on every
    rank (after ``put_replicated``); the full parameters are released at
    once."""

    def __init__(self, model: nn.Module, plan: Dict[str, Optional[Split]],
                 data_group, replica_group=None, model_group=None):
        self.data_group, self.replica_group = data_group, replica_group
        self.model_group = model_group
        self.n, self.rank = group_size(data_group), group_rank(data_group)
        self.m, self.mrank = group_size(model_group), group_rank(model_group)
        self.params = dict(model.named_parameters())
        self.plan = {k: s for k, s in plan.items() if s is not None}
        self.axes = {k: d for k, (_, d) in self.plan.items() if d is not None}
        self.model_axes = {k: d for k, (d, _) in self.plan.items()
                           if d is not None}
        self.shapes = {k: tuple(self.params[k].shape) for k in self.plan}
        self._name = {id(p): k for k, p in self.params.items()}
        self.shards: Dict[str, nn.Parameter] = {}
        with torch.no_grad():
            for k in self.plan:
                p = self.params[k]
                self.shards[k] = nn.Parameter(
                    self._slice(p.detach(), k).clone(),
                    requires_grad=p.requires_grad)
        self._shard_name = {id(s): k for k, s in self.shards.items()}
        self.gathered = True
        self.release()

    # -- layout ----------------------------------------------------------

    def _model_block(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's block along the model dim of a full tensor of
        parameter ``name`` (all of it where ``model`` does not split it)."""
        dim = self.model_axes.get(name)
        return full if dim is None else full.chunk(self.m, dim=dim)[self.mrank]

    def _slice(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's block of a full tensor of parameter ``name``: its
        model block, and the rank's part of that along the data dim."""
        block = self._model_block(full, name)
        dim = self.axes.get(name)
        if dim is not None:
            block = block.chunk(self.n, dim=dim)[self.rank]
        return block.contiguous()

    def gather_full(self, items: List[Tuple[str, torch.Tensor]]
                    ) -> List[torch.Tensor]:
        """(split parameter's name, block-shaped tensor: a value, a
        gradient, an Adam moment) -> the full tensors, in order: gathered
        over the model group, then over the data group, one all-gather
        per dtype and group (a collective: every rank calls it with the
        same names in the same order)."""
        out = [t.detach() for _, t in items]
        for group, size, dims in ((self.model_group, self.m, self.model_axes),
                                  (self.data_group, self.n, self.axes)):
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i, (k, _) in enumerate(items):
                if k in dims:
                    by_dtype.setdefault(out[i].dtype, []).append(i)
            for idx in by_dtype.values():
                rows = _flat_gather(torch.cat([out[i].reshape(-1)
                                               for i in idx]), group)
                off = 0
                for i in idx:
                    t, n = out[i], out[i].numel()
                    out[i] = torch.cat([rows[r, off:off + n].view(t.shape)
                                        for r in range(size)],
                                       dim=dims[items[i][0]])
                    off += n
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
        the rank's block (its model block of the rank's own gradient, the
        mean of that over the data group, then over the replica group) in
        its block's ``grad``; the replicated parameters' gradients
        averaged over ``batch_group`` (``all_reduce_grads``) and, with a
        model axis, broadcast from the model group's first rank."""
        named = [(k, self.params[k].grad) for k in self.shards]
        for s in self.shards.values():
            s.grad = None
        with torch.no_grad():
            by_dtype: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
            for k, g in named:
                if g is not None:
                    by_dtype.setdefault(g.dtype, []).append(
                        (k, self._model_block(g, k)))
            for items in by_dtype.values():
                scatter = [(k, g) for k, g in items if k in self.axes]
                whole = [(k, g) for k, g in items if k not in self.axes]
                for part, mine in self._data_means(scatter, whole):
                    if group_size(self.replica_group) > 1:
                        dist.all_reduce(mine, op=dist.ReduceOp.SUM,
                                        group=self.replica_group)
                        mine.div_(group_size(self.replica_group))
                    off = 0
                    for k, _ in part:
                        s = self.shards[k]
                        s.grad = mine[off:off + s.numel()].view(s.shape)
                        off += s.numel()
        for k in self.shards:
            self.params[k].grad = None
        rest = [p for k, p in self.params.items() if k not in self.shards]
        all_reduce_grads(rest, batch_group)
        if self.m > 1:
            with torch.no_grad():
                _broadcast_from_first([p.grad for p in rest
                                       if p.grad is not None],
                                      self.model_group)

    def _data_means(self, scatter, whole):
        """(items, the flat means over the data group of the rank's part
        of them): the blocks split over ``data`` reduce-scattered, those
        split over ``model`` alone all-reduced (one bucket each)."""
        out = []
        if scatter:
            chunks = [g.chunk(self.n, dim=self.axes[k]) for k, g in scatter]
            packed = torch.cat([c[r].reshape(-1) for r in range(self.n)
                                for c in chunks]).view(self.n, -1)
            out.append((scatter, _flat_reduce_scatter(packed,
                                                      self.data_group)))
        if whole:
            flat = torch.cat([g.reshape(-1) for _, g in whole])
            if self.n > 1:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                group=self.data_group)
            out.append((whole, flat))
        for _, mine in out:
            mine.div_(self.n)
        return out

    def _leaf_terms(self, groups: Iterable[Iterable[torch.Tensor]],
                    grads: bool, split_term, finish, rep_term
                    ) -> List[List[torch.Tensor]]:
        """For each group of parameters (the module's or the optimizers'
        slices), one 0-d term per parameter with a value (``grads``: its
        full gradient, else the parameter; one without a gradient is
        left out), in the group's order: ``rep_term(t)`` of a replicated
        one, ``finish(sum, dtype)`` of a split one, where ``sum`` is its
        blocks' float32 ``split_term`` summed over the groups whose axis
        splits it (one all-reduce over each for all of them: a leaf that
        one group holds in copies adds nothing on that group's other
        ranks, so it counts once)."""
        slots = []
        # the split leaves' terms by the axes that split them: both, data
        # alone, model alone (so each all-reduce zeroes one slice)
        kinds: Tuple[list, list, list] = ([], [], [])
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
                    ki = (0 if k in self.axes and k in self.model_axes
                          else 1 if k in self.axes else 2)
                    row.append((ki, len(kinds[ki]), v.dtype))
                    kinds[ki].append(split_term(v))
                else:
                    row.append(rep_term(v))
            slots.append(row)
        if any(kinds):
            reduced = torch.stack([t for kind in kinds for t in kind])
            n_both, n_data = len(kinds[0]), len(kinds[1])
            start = (0, n_both, n_both + n_data)
            for group, size, rank, copies in (
                    (self.data_group, self.n, self.rank,
                     slice(n_both + n_data, None)),
                    (self.model_group, self.m, self.mrank,
                     slice(n_both, n_both + n_data))):
                if size > 1:
                    if rank > 0:
                        reduced[copies] = 0.0
                    dist.all_reduce(reduced, op=dist.ReduceOp.SUM,
                                    group=group)
        return [[finish(reduced[start[x[0]] + x[1]], x[2])
                 if isinstance(x, tuple) else x for x in row]
                for row in slots]

    def sq_sums(self, groups: Iterable[Iterable[torch.Tensor]],
                grads: bool) -> List[torch.Tensor]:
        """For each group of parameters the sum of squares of the full
        tensors' gradients (``grads``) or values, as
        ``training/state.py::global_norm`` sums one process's: per
        parameter ``sum(square(t))`` in its dtype (a split one's blocks
        summed in float32 over the data and model groups, then rounded
        once to its dtype, as a reduction of the whole leaf rounds), added
        in order
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
        split one's from its blocks' float32 squares summed over the data
        and model groups), grouped by dtype in order of first appearance,
        and the 2-norm of them all in float32."""
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
        """Bytes of the parameters (blocks and replicated) and of the
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
                min_size: int = FSDP_MIN_SIZE, model_group=None) -> FSDP:
    """``FSDP`` of ``model`` with ``fsdp_plan`` at the data group's and
    the model group's sizes (``model_group`` None: a model axis of 1):
    call it on every rank after the parameters were made equal
    (``put_replicated``), and build the optimizers through
    ``FSDP.shard_of`` after it."""
    return FSDP(model, fsdp_plan(model, group_size(data_group), min_size,
                                 group_size(model_group)),
                data_group, replica_group, model_group)


__all__ = ["FSDP", "fully_shard"]
