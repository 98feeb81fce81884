"""The ranks of ``tests/test_torch_parallel.py``: one process per rank of
a gloo group on the CPU, importing torch and the port and nothing of JAX
(so a rank starts in seconds).

    python tests/torch_dp_ranks.py <case> <rank> <world> <port> <payload>
        <out_dir>

``payload`` is a ``torch.save`` file the test wrote; each rank writes
``<out_dir>/rank<r>.pt``. The cases:

- ``steps``: for each model of the payload, its runs of train steps from
  its initial state on the rank's rows of each global batch; a step with
  recorded draws replays them (``ShardedDraws`` over ``ReplayDraws`` of
  the global draws), and with recorded decisions also those
  (``TapReplay``: the port's side of tests/test_torch_bf16.py's
  ``Taps``, on the rank's rows); returns each step's metrics and
  gradients and the parameters and buffers after the run
  (``run_steps``, which the test also calls in one process on the global
  batches);
- ``fit``: ``VAEXperiment.fit`` of TSynthetic epochs: the rank's batches,
  the checkpoint files, a stop requested on one rank, a resume;
- ``misc``: what a world of 2 refuses and takes (``sharding: fsdp`` with
  ``model_axis: 2``, ``scan_steps`` over gloo), and ``dcn_replicas``;
- ``fsdp_fit``: ``VAEXperiment.fit`` under ``sharding: fsdp``, a resume,
  and checkpoints moved between FSDP, DP and one process;
- ``sp``: steps over a mesh with a model axis; ``sharding: dp`` over a
  model axis of 2, and ``run.train`` under ``sharding: sp`` with a resume
  (``case_sp_fit``); then the replays of JAX's SP steps
  (tests/test_torch_sp.py);
- ``fsdp_tp``: as ``sp`` with ``case_fsdp_tp_fit`` (``fit`` under
  ``sharding: fsdp`` with ``model_axis: 2``, a resume, and checkpoints
  moved between one process, DP, FSDP and FSDP with a model axis) in
  place of ``case_sp_fit`` (tests/test_torch_fsdp_tp.py).

A spec of ``steps`` with ``mesh`` (``dcn_replicas``, ``model_axis``) trains
over that mesh: the batch split over its batch group, the state's model
group the ranks along ``model`` (sequence parallelism where the model has
``seq_axis``); a run with ``record_ops`` records each generator-drawn
step's ``ctvae::`` op calls with their shapes (``OpShapes``); a run with
``scan`` K takes its K steps (one mode) as one ``make_multi_train_step``
call and records the last step's metrics and gradients alone.

A model of ``steps`` whose spec holds ``fsdp`` (the ``fsdp_min_size``)
trains under FSDP over the mesh's data group (``dcn_replicas``: the
hybrid mesh; with ``mesh``, that mesh's, and its model group splits the
leaves of the tensor-parallel rules), and its results are the full
tensors gathered from the blocks, beside the blocks' and Adam moments'
shapes, the plan and the bytes resident between steps.

``ReplayDraws``, ``GammaSlot`` and ``TapReplay`` live here, free of
JAX; ``torch_port_common`` re-exports the first two.
"""

from __future__ import annotations

import contextlib
import copy
import os
import signal
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class GammaSlot:
    """A gamma draw recorded at trace time and filled when the program
    runs (so fetch the JAX results, which waits for it, before the
    replay)."""

    def __init__(self, shape):
        self.shape, self.value = tuple(shape), None


class ReplayDraws:
    """The port's draw provider, replaying a ``DrawRecorder``'s arrays."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        assert self.draws, f"port drew one more {kind} than JAX"
        k, a = self.draws.pop(0)
        if isinstance(a, GammaSlot):
            assert a.value is not None, "a gamma draw JAX never ran"
            a = a.value
        assert k == kind and a.shape == tuple(shape), (k, a.shape, kind,
                                                       tuple(shape))
        return torch.from_numpy(a.copy())

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, low, high, shape):
        return self._next("randint", shape)

    def cauchy(self, shape):
        return self._next("cauchy", shape)

    def gamma(self, alpha):
        return self._next("gamma", alpha.shape)

    def permutation(self, rows, n):
        return self._next("permutation", (rows, n))

    def done(self):
        return not self.draws


ULP = 2.0 ** -8          # one bfloat16 ulp, relative


class TapReplay:
    """JAX's recorded decisions replayed into the port after a check: the
    port's side of ``Taps`` (tests/test_torch_bf16.py), which records
    ``rec`` (kind -> FIFO of arrays, in call order) from a JAX run on the
    global batch: ``vq`` (a multi-codebook VQ search's indices, beside
    JAX's latents; with ``lone``, the search of a lone ``VectorQuantizerMS``,
    VQVAE's, recorded as one codebook's), ``ct`` (``ct_postprocess``'s
    argmax, beside its input) and ``bern`` (a Gumbel-Bernoulli sample).
    The port's decision may
    differ from JAX's only inside the rounding that the two sides' inputs
    differ by; the port then continues on JAX's, and ``flips`` counts
    such elements per kind. Without ``check`` JAX's decisions are replayed
    unread (inside a ``torch.export`` trace, whose values are not there
    to check).

    On rank ``rank`` of ``world`` whose batch holds ``rows`` rows, each
    recorded array is cut to the rank's rows: a leading dim of L = G x
    ``rows`` local rows is G blocks of the batch, block-major (the causal
    mode's A actions), of which the global array holds G x ``world``
    blocks of ``rows`` rows, the rank's ``rank``-th of each."""

    def __init__(self, rec, flips=None, rank: int = 0, world: int = 1,
                 rows: Optional[int] = None, lone: bool = False,
                 check: bool = True):
        self.rec = rec
        self.flips = flips if flips is not None else {k: 0 for k in rec}
        self.rank, self.world, self.rows = rank, world, rows
        self.lone, self.check = lone, check

    def _mine(self, a: np.ndarray, local: int) -> np.ndarray:
        if self.world == 1:
            return a
        g = local // self.rows
        assert a.shape[0] == local * self.world, (a.shape, local)
        a = a.reshape((g, self.world, self.rows) + a.shape[1:])
        return a[:, self.rank].reshape((local,) + a.shape[3:])

    def _pop(self, kind: str, local: int) -> List[np.ndarray]:
        return [self._mine(a, local) for a in self.rec[kind].pop(0)]

    def install(self, setattr_) -> None:
        """Patch the three decisions with ``setattr_(obj, name, value)``
        (``pytest.MonkeyPatch.setattr``, or ``Patches.setattr``)."""
        from ctvae_torch.models import ct_vae as tct
        from ctvae_torch.models import quantizers as tq
        taps = self
        vq_cls = (tq.VectorQuantizerMS if self.lone
                  else tq.MultipleCodebookVectorQuantizer)
        orig_ci = vq_cls.compute_inds

        def compute_inds(module, latents):
            jl, ji = taps._pop("vq", latents.shape[0])
            ji = torch.from_numpy(ji.astype(np.int64))
            if taps.check:
                got = orig_ci(module, latents).cpu()
                if taps.lone:   # one codebook: [B, H, W] as [B, 1, H, W]
                    got, module = got[:, None], _OneCodebook(module)
                taps.check_vq(module,
                              latents.detach().cpu().double().numpy(), jl,
                              got, ji)
            return (ji[:, 0] if taps.lone else ji).to(latents.device)

        orig_pp = tct.CTMCQVAE.ct_postprocess

        def ct_postprocess(module, seq):
            js, ji = taps._pop("ct", seq.shape[0])
            ji = torch.from_numpy(ji.astype(np.int64))
            if not taps.check:
                return ji.to(seq.device)
            got = orig_pp(module, seq).cpu()
            flip = (got != ji).reshape(-1).numpy()
            if flip.any():
                # JAX's value at the port's choice within 2 ulps of its max
                js = js.reshape(-1, js.shape[-1])
                top = js.max(-1)
                mine = js[np.arange(len(js)), got.reshape(-1).numpy()]
                assert (top - mine <= 2 * ULP * np.abs(top))[flip].all()
                taps.flips["ct"] += int(flip.sum())
            return ji.to(seq.device)

        orig_bern = tct.st_bernoulli_gumbel

        def st_bernoulli_gumbel(gumbel, probs, tau=1.0):
            out = orig_bern(gumbel, probs, tau)
            (hard,) = taps._pop("bern", probs.shape[0])
            picked = out.detach() > 0.5
            mine = picked.to(out.dtype)
            flip = (picked.cpu().numpy() != (hard > 0.5) if taps.check
                    else np.zeros(1, bool))
            if flip.any():
                # the soft sample, from the port's own logits, near 1/2
                logits = torch.log(torch.clamp(torch.stack(
                    [1.0 - probs, probs], -1), min=tct.CLAMP_EPS))
                soft = torch.softmax((logits + gumbel) / tau, -1)[..., 1]
                soft = soft.detach().cpu().double().numpy()
                assert (np.abs(soft - 0.5) <= 0.05)[flip].all()
                taps.flips["bern"] += int(flip.sum())
            return out + (torch.tensor(hard).to(out) - mine).to(out)

        setattr_(vq_cls, "compute_inds", compute_inds)
        setattr_(tct.CTMCQVAE, "ct_postprocess", ct_postprocess)
        setattr_(tct, "st_bernoulli_gumbel", st_bernoulli_gumbel)

    def check_vq(self, module, x_port, x_jax, got, want):
        """A flipped index only where JAX's float32 distance gap between
        the two codes is within what the latents' difference can move it:
        2 sum_i |x_port - x_jax|_i |e_a - e_b|_i (plus float32 slack)."""
        rd = module.reduced_embedding_dim
        for c, q in enumerate(module.quantizers):
            sl = slice(c * rd, (c + 1) * rd) if module.slicing == "chunk" \
                else slice(c, c + rd)
            xj = x_jax[..., sl].reshape(-1, rd).astype(np.float64)
            xp = x_port[..., sl].reshape(-1, rd)
            e = q.embedding.detach().cpu().double().numpy()
            a = want[:, c].reshape(-1).numpy()
            b = got[:, c].reshape(-1).numpy()
            flip = a != b
            if not flip.any():
                continue
            d = ((xj[:, None, :] - e[None]) ** 2).sum(-1)
            rows = np.arange(len(a))
            gap = d[rows, b] - d[rows, a]
            room = 2 * (np.abs(xp - xj) * np.abs(e[b] - e[a])).sum(-1) + 1e-6
            assert (gap <= room)[flip].all(), (gap[flip], room[flip])
            self.flips["vq"] += int(flip.sum())

    def done(self) -> bool:
        return not any(self.rec.values())


class _OneCodebook:
    """A lone ``VectorQuantizerMS`` seen as a multi-codebook quantizer of
    one codebook (``TapReplay.check_vq``'s view)."""

    slicing = "chunk"

    def __init__(self, quantizer):
        self.quantizers = [quantizer]
        self.reduced_embedding_dim = quantizer.embedding_dim


class Patches:
    """``setattr`` whose old values ``undo`` puts back."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            setattr(*self._saved.pop())


# --- steps ---------------------------------------------------------------------

def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _mesh_groups(spec: Dict[str, Any], group):
    """(data group, replica group) of the spec's mesh: ``dcn_replicas``
    > 1 the hybrid one."""
    from ctvae_torch import parallel
    n = spec.get("dcn_replicas", 1)
    mesh = parallel.make_hybrid_mesh(n) if n > 1 else parallel.make_mesh()
    return parallel.mesh_data_group(mesh), parallel.mesh_replica_group(mesh)


def _sp_groups(spec: Dict[str, Any]):
    """(batch group, model group, (data group, replica group)) of the
    spec's mesh with a model axis, ``spec['mesh']`` = (dcn_replicas,
    model_axis)."""
    from ctvae_torch import parallel
    n, m = spec["mesh"]
    mesh = (parallel.make_hybrid_mesh(n, m) if n > 1
            else parallel.make_mesh(m))
    return (parallel.mesh_batch_group(mesh), parallel.mesh_model_group(mesh),
            (parallel.mesh_data_group(mesh),
             parallel.mesh_replica_group(mesh)))


def _train_state(spec: Dict[str, Any], model, group, groups, seed: int,
                 model_group=None):
    """The state of ``model``: under FSDP (``spec['fsdp']``, a group) the
    split parameters' blocks and the optimizers over them."""
    from ctvae_torch.parallel import fully_shard
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    fsdp = None
    if spec.get("fsdp") and group is not None:
        fsdp = fully_shard(model, *groups, min_size=spec["fsdp"],
                           model_group=model_group)
    return tstate.create_train_state(
        model, topt.build_optimizers(spec["exp"], model, 4, fsdp=fsdp),
        seed=seed, group=group, fsdp=fsdp, model_group=model_group)


class OpShapes:
    """A ``TorchDispatchMode`` context that records each call of a
    ``ctvae::`` custom op: (op name, its tensor arguments' shapes, its
    tensor outputs' shapes)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        calls = self.calls = []

        def shapes(v):
            v = v if isinstance(v, (list, tuple)) else [v]
            return [tuple(t.shape) for t in v if isinstance(t, torch.Tensor)]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ns, _, name = func._schema.name.partition("::")
                if ns.startswith("ctvae"):
                    calls.append((name, shapes(args), shapes(out)))
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def full_grads(state) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient of the last step at its full shape
    (under FSDP gathered from the slices: a collective)."""
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    fsdp = state.fsdp
    if fsdp is not None:
        items = [(k, s.grad) for k, s in fsdp.shards.items()
                 if s.grad is not None]
        grads.update(zip([k for k, _ in items], fsdp.gather_full(items)))
    return grads


def resident_bytes(state) -> int:
    """Bytes of the parameters and Adam moments held between steps."""
    if state.fsdp is not None:
        return state.fsdp.resident_bytes(state.optimizers)
    ts = list(state.model.parameters())
    for opt in state.optimizers:
        for st in opt.adam.state.values():
            ts += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    return sum(t.numel() * t.element_size() for t in ts)


def run_steps(spec: Dict[str, Any], group=None) -> List[Dict[str, Any]]:
    """The runs of ``spec`` (``cfg``, ``state_dict``, ``exp``, ``runs``:
    each a list of ``(mode, global batch, draws or None)`` steps from the
    initial state, with ``M_N``, ``seed`` and ``watch`` (the per-module
    norms of ``watch_gradients``) and ``scan`` (its steps as one
    multi-step call); ``fsdp``: the ``fsdp_min_size`` of an FSDP run,
    with ``dcn_replicas`` or ``mesh``; ``device``,
    the CPU by default) on the rank's rows of each batch (all of it
    without ``group``). Per run: each
    step's metrics and gradients, the parameters and buffers after it,
    the state's step; under FSDP also the slices' and Adam moments'
    shapes and dtypes, the slices' values and the bytes resident after the
    run. A step of four items, ``(mode, batch, draws, decisions)``, also
    replays JAX's recorded decisions (``TapReplay``), and its run counts
    their flips (``flips``)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import local_rows
    from ctvae_torch.training import state as tstate
    device = spec.get("device", "cpu")
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model0 = build_model(dict(spec["cfg"]), device=device)
    model0.load_state_dict(spec["state_dict"])
    groups = (_mesh_groups(spec, group) if spec.get("fsdp")
              and group is not None and not spec.get("mesh") else None)
    model_group = None
    if spec.get("mesh") and group is not None:
        group, model_group, groups = _sp_groups(spec)
    out = []
    for run in spec["runs"]:
        model = copy.deepcopy(model0)
        state = _train_state(spec, model, group, groups, run.get("seed", 0),
                             model_group)
        state.step = run.get("step", 0)
        metrics, grads, ops = [], [], []
        flips = {"vq": 0, "ct": 0, "bern": 0}
        graphed = None
        if run.get("scan"):
            m, graphed = _scan_run(run, state, group, device)
            metrics.append(m)
            grads.append(full_grads(state))
        for mode, batch, draws, *decisions in ([] if run.get("scan")
                                               else run["steps"]):
            if group is not None:
                batch = local_rows(batch, group)
            step_fn = tstate.make_train_step(
                mode, watch_modules=run.get("watch", False),
                M_N=run.get("M_N", 1.0))
            if draws is None:
                rec = OpShapes() if run.get("record_ops") else None
                with rec or contextlib.nullcontext():
                    m = step_fn(state, {k: v.to(device)
                                        for k, v in _tensors(batch).items()})
                if rec is not None:
                    ops.append(rec.calls)
            else:
                replay = ReplayDraws(draws)
                patches = Patches()
                patches.setattr(tstate, "Draws", lambda gen, device: replay)
                taps = None
                if decisions:
                    from ctvae_torch.parallel import group_rank, group_size
                    taps = TapReplay(copy.deepcopy(decisions[0]), flips,
                                     group_rank(group), group_size(group),
                                     len(batch["image"]))
                    taps.install(patches.setattr)
                try:
                    m = step_fn(state, {k: v.to(device) for k, v in
                                        _tensors(batch).items()})
                finally:
                    patches.undo()
                assert replay.done(), "the step drew fewer draws than JAX"
                assert taps is None or taps.done(), "decisions left"
            metrics.append({k: v.clone() for k, v in m.items()})
            grads.append(full_grads(state))
        res = {"metrics": metrics, "grads": grads, "step": state.step,
               "flips": flips, "ops": ops, "graphed": graphed,
               "buffers": {n: b.clone() for n, b in model.named_buffers()},
               "resident_bytes": resident_bytes(state)}
        with tstate.full_params(state):
            res["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
        if state.fsdp is not None:
            fsdp = state.fsdp
            res["slices"] = {k: s.detach().clone()
                             for k, s in fsdp.shards.items()}
            res["axes"] = dict(fsdp.axes)
            res["plan"] = dict(fsdp.plan)
            res["moments"] = [
                {k: tuple(opt.adam.state[p]["exp_avg"].shape)
                 for k, p in zip(_param_names(model, opt, fsdp), opt.params)
                 if p in opt.adam.state} for opt in state.optimizers]
            res["moment_dtypes"] = [
                {k: (p.dtype, opt.adam.state[p]["exp_avg"].dtype,
                     opt.adam.state[p]["exp_avg_sq"].dtype)
                 for k, p in zip(_param_names(model, opt, fsdp), opt.params)
                 if p in opt.adam.state} for opt in state.optimizers]
        out.append(res)
    return out


def _scan_run(run, state, group, device):
    """A run's steps (one mode, generator-drawn) as one
    ``make_multi_train_step`` call on the rank's rows of each batch:
    (the last step's metrics, whether a graph replayed)."""
    from ctvae_torch.parallel import local_rows
    from ctvae_torch.training import state as tstate
    (mode,) = {s[0] for s in run["steps"]}
    rows = [local_rows(b, group) if group is not None else b
            for _, b, _ in run["steps"]]
    stacked = {k: torch.from_numpy(np.stack([r[k] for r in rows])).to(device)
               for k in rows[0]}
    multi = tstate.make_multi_train_step(mode, len(rows),
                                         M_N=run.get("M_N", 1.0))
    m = multi(state, stacked)
    return {k: v.clone() for k, v in m.items()}, multi.graphed


def _param_names(model, opt, fsdp) -> List[str]:
    """The names of an optimizer's parameters (slices by their
    parameter's name)."""
    names = {id(fsdp.shard_of(p)): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in opt.params]


def case_steps(payload, group) -> Dict[str, Any]:
    """``run_steps`` of each model of the payload; with ``equal_values``
    (equal on every rank) also their ``all_mean``; on rank 0, last, the
    ``single`` specs' runs in one process (no group)."""
    from ctvae_torch.parallel import all_mean, rank
    out = {name: run_steps(spec, group)
           for name, spec in payload["models"].items()}
    if "equal_values" in payload:
        out["equal_values"] = all_mean(
            {"v": payload["equal_values"].clone()}, group)["v"]
    if payload.get("single") and rank() == 0:
        out["single"] = {name: run_steps(spec)
                         for name, spec in payload["single"].items()}
    return out


# --- fit -----------------------------------------------------------------------

def _experiment(payload, ckpt_dir: str, exp_extra=None):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    model = build_model(dict(payload["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(
                            payload["seed"]))
    data = VAEDataset(**payload["data"])
    data.setup()
    ckpt = CheckpointManager(ckpt_dir, top_k=2)
    exp = VAEXperiment(model, dict(payload["exp"], **(exp_extra or {})),
                       data, ckpt_manager=ckpt)
    exp.setup(seed=payload["seed"])
    return exp


def _params(exp) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict`` (under FSDP gathered)."""
    from ctvae_torch.training.state import full_params
    with full_params(exp.state):
        return {n: t.detach().clone() for n, t in
                exp.model.state_dict().items()}


def case_fit(payload, group) -> Dict[str, Any]:
    from ctvae_torch.data import TransitionBatchScheduler
    from ctvae_torch.parallel import rank, world_size
    from ctvae_torch.training import install_preemption_handler
    out: Dict[str, Any] = {}
    root = payload["root"]
    exp = _experiment(payload, os.path.join(root, "run"))
    data = exp.data
    out["hosts"] = (data.host_id, data.num_hosts)
    # the rank's batches against the scheduler's slices of the global ones
    B = data.train_batch_size
    mine = TransitionBatchScheduler(
        data.train_dataset, batch_size=B, limit=data.limit, seed=data.seed,
        host_id=rank(), num_hosts=world_size())
    whole = TransitionBatchScheduler(
        data.train_dataset, batch_size=B * world_size(), limit=data.limit,
        seed=data.seed)
    slices = [(m, idx[rank() * B:(rank() + 1) * B])
              for m, idx in whole.epoch(0)]
    got = list(mine.epoch(0))
    out["slices_match"] = (len(got) == len(slices) > 0 and all(
        m == m2 and np.array_equal(i, i2)
        for (m, i), (m2, i2) in zip(got, slices)))
    seen = list(data.train_dataloader(0))
    out["batches_match"] = len(seen) == len(got) and all(
        b["mode"] == m and np.array_equal(
            b["image"], data.train_dataset.get_batch(i, m)["image"])
        for b, (m, i) in zip(seen, got))
    # one epoch; rank 0 alone writes
    saves: List[str] = []
    real_save = torch.save

    def spy(obj, f, *a, **k):
        saves.append(str(f))
        return real_save(obj, f, *a, **k)
    torch.save = spy
    try:
        exp.fit(1, seed=payload["seed"])
    finally:
        torch.save = real_save
    out["saves"] = saves
    out["writes"] = exp.ckpt.writes
    out["after_1"] = _params(exp)
    out["step_1"] = exp.global_step
    # a stop requested on rank 1 alone, during epoch 1: both stop there
    stop_rank = payload["stop_rank"]
    if rank() == stop_rank:
        train_epoch = exp.train_epoch

        def stopping(epoch):
            os.kill(os.getpid(), signal.SIGTERM)
            return train_epoch(epoch)
        exp.train_epoch = stopping
    exp.start_epoch = 1
    previous = install_preemption_handler(exp)
    try:
        exp.fit(3, seed=payload["seed"])
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    out["stopped_at"] = exp.global_step
    out["after_stop"] = _params(exp)
    # a resume from rank 0's file on every rank continues to epoch 3
    resumed = _experiment(payload, os.path.join(root, "run"))
    # setup's broadcast waited for rank 0, whose save is on disk
    out["last_after_stop"] = resumed.ckpt.restore("last")["step"]
    resumed.restore_full_state("last")
    out["resumed_from"] = (resumed.global_step, resumed.start_epoch)
    out["restored_equal"] = all(
        torch.equal(t, out["after_stop"][n])
        for n, t in _params(resumed).items())
    resumed.fit(3, seed=payload["seed"])
    out["resumed_end"] = resumed.global_step
    out["after_resume"] = _params(resumed)
    # the same three epochs without a stop
    straight = _experiment(payload, os.path.join(root, f"straight{rank()}"))
    straight.ckpt.writes = False
    straight.fit(3, seed=payload["seed"])
    out["straight"] = _params(straight)
    out["straight_end"] = straight.global_step
    return out


# --- fsdp_fit: the loop and checkpoints under FSDP ------------------------------

def _differ(a, b, path: str = "") -> List[str]:
    """Where two checkpoint states differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ok = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
              and a.shape == b.shape and a.dtype == b.dtype
              and torch.equal(a.cpu(), b.cpu()))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(map(str, set(a) ^ set(b)))}"]
        return [d for k in a for d in _differ(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths {len(a)} / {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differ(x, y, f"{path}/{i}")]
    return [] if a == b else [f"{path}: {a!r} / {b!r}"]


def case_fsdp_fit(payload, group) -> Dict[str, Any]:
    """``fit`` under ``sharding: fsdp`` with a resume against the same
    epochs without one; checkpoints of an FSDP run, a DP run and one
    process, each restored into an FSDP run, DP ranks and one process,
    whose state then equals the file's; the dtypes of each file's Adam
    moments."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import rank
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    from ctvae_torch.utils.checkpoint import _load
    out: Dict[str, Any] = {}
    root = payload["root"]
    fsdp = dict(sharding="fsdp", fsdp_min_size=payload["fsdp"])
    saves: List[str] = []
    real_save = torch.save

    def spy(obj, f, *a, **k):
        saves.append(str(f))
        return real_save(obj, f, *a, **k)
    torch.save = spy
    try:
        exp = _experiment(payload, os.path.join(root, "fsdp"), fsdp)
        out["split"] = sorted(exp.state.fsdp.axes)
        exp.fit(1, seed=payload["seed"])
    finally:
        torch.save = real_save
    out["saves"] = saves
    out["after_1"] = _params(exp)
    resumed = _experiment(payload, os.path.join(root, "fsdp"), fsdp)
    resumed.restore_full_state("last")
    out["restored_equal"] = not _differ(_params(resumed), out["after_1"])
    resumed.fit(2, seed=payload["seed"])
    out["resumed"] = _params(resumed)
    out["resumed_step"] = resumed.global_step
    straight = _experiment(payload, os.path.join(root, f"straight{rank()}"),
                           fsdp)
    straight.ckpt.writes = False
    straight.fit(2, seed=payload["seed"])
    out["straight"] = _params(straight)
    out["straight_step"] = straight.global_step
    # the sources: an FSDP run's last, a DP run's last, one process's file
    dp = _experiment(payload, os.path.join(root, "dp"))
    dp.fit(1, seed=payload["seed"])
    model = build_model(dict(payload["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(
                            payload["seed"] + 1))
    one = tstate.create_train_state(
        model, topt.build_optimizers(payload["exp"], model, 4), seed=9)
    tstate.make_train_step("action")(one, {
        k: torch.from_numpy(v) for k, v in payload["batch"].items()})
    single = os.path.join(root, f"single{rank()}.pt")
    torch.save(one.state_dict(), single)
    # rank 0's DP checkpoint is on disk once every rank got here
    torch.distributed.barrier(group=group)
    sources = {"fsdp": os.path.join(root, "fsdp", "last"),
               "dp": os.path.join(root, "dp", "last"), "single": single}
    out["moves"], out["file_moment_dtypes"] = {}, {}
    for src, path in sources.items():
        want = _load(path)
        out["file_moment_dtypes"][src] = sorted({
            str(st[k].dtype) for opt in want["optimizers"]
            for st in opt["adam"]["state"].values()
            for k in ("exp_avg", "exp_avg_sq")})
        for dst in ("fsdp", "dp", "single"):
            if dst == "single":
                m = build_model(dict(payload["cfg"]), device="cpu")
                st = tstate.create_train_state(
                    m, topt.build_optimizers(payload["exp"], m, 4))
                st.load_state_dict(_load(path))
            else:
                e = _experiment(payload, os.path.join(root, f"x{rank()}"),
                                fsdp if dst == "fsdp" else None)
                e.restore_full_state(path)
                st = e.state
            out["moves"][f"{src}-{dst}"] = _differ(st.state_dict(), want)
    return out


def case_fsdp_tp_fit(payload, group) -> Dict[str, Any]:
    """``fit`` under ``sharding: fsdp`` with ``model_axis: 2`` (a world of
    2: mesh (data 1, model 2)) with a resume against the same epochs
    without one; checkpoints of that run, of an FSDP run over ``data``,
    of DP ranks (one step each on the payload's batch) and of one process,
    each restored into each of those four, whose state then equals the
    file's."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import rank
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    from ctvae_torch.utils.checkpoint import _load
    out: Dict[str, Any] = {}
    root = payload["root"]
    kinds = {"tp": dict(sharding="fsdp", fsdp_min_size=payload["fsdp"],
                        model_axis=2),
             "fsdp": dict(sharding="fsdp", fsdp_min_size=payload["fsdp"]),
             "dp": None}
    tp = kinds["tp"]
    exp = _experiment(payload, os.path.join(root, "tp"), tp)
    out["plan"] = dict(exp.state.fsdp.plan)
    exp.fit(1, seed=payload["seed"])
    out["after_1"] = _params(exp)
    resumed = _experiment(payload, os.path.join(root, "tp"), tp)
    resumed.restore_full_state("last")
    out["restored_equal"] = not _differ(_params(resumed), out["after_1"])
    resumed.fit(2, seed=payload["seed"])
    out["resumed"] = _params(resumed)
    out["resumed_step"] = resumed.global_step
    straight = _experiment(payload, os.path.join(root, f"straight{rank()}"),
                           tp)
    straight.ckpt.writes = False
    straight.fit(2, seed=payload["seed"])
    out["straight"] = _params(straight)
    out["straight_step"] = straight.global_step
    # the sources: the run's last, a step of FSDP and of DP ranks, and a
    # step of one process
    sources = {"tp": os.path.join(root, "tp", "last")}
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    for kind in ("fsdp", "dp"):
        e = _experiment(payload, os.path.join(root, f"{kind}{rank()}"),
                        kinds[kind])
        tstate.make_train_step("action")(e.state, batch)
        sd = e.state.state_dict()
        sources[kind] = os.path.join(root, f"{kind}.pt")
        if rank() == 0:
            torch.save(sd, sources[kind])
    model = build_model(dict(payload["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(
                            payload["seed"] + 1))
    one = tstate.create_train_state(
        model, topt.build_optimizers(payload["exp"], model, 4), seed=9)
    tstate.make_train_step("action")(one, batch)
    sources["single"] = os.path.join(root, f"single{rank()}.pt")
    torch.save(one.state_dict(), sources["single"])
    torch.distributed.barrier(group=group)      # rank 0's files are on disk
    out["moves"] = {}
    for src, path in sources.items():
        want = _load(path)
        for dst in ("tp", "fsdp", "dp", "single"):
            if dst == "single":
                m = build_model(dict(payload["cfg"]), device="cpu")
                st = tstate.create_train_state(
                    m, topt.build_optimizers(payload["exp"], m, 4))
                st.load_state_dict(_load(path))
            else:
                e = _experiment(payload, os.path.join(root, f"x{rank()}"),
                                kinds[dst])
                e.restore_full_state(path)
                st = e.state
            out["moves"][f"{src}-{dst}"] = _differ(st.state_dict(), want)
    return out


# --- misc: refusals and dcn_replicas -------------------------------------------

def _raises(fn, exc=NotImplementedError, text="ROADMAP A8") -> str:
    """'ok' when ``fn`` raises ``exc`` naming ``text``, else what it did."""
    try:
        fn()
    except exc as e:
        return "ok" if text in str(e) else f"message: {e}"
    except Exception as e:          # noqa: BLE001 - reported to the test
        return f"raised {type(e).__name__}: {e}"
    return "did not raise"


def case_misc(payload, group) -> Dict[str, Any]:
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import REPLICA_AXIS, DATA_AXIS, MODEL_AXIS
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    out: Dict[str, Any] = {"refused": {}, "accepted": {}, "taken": {}}
    for name, cfg in {**payload["cross_batch"], **payload["per_row"]}.items():
        model = build_model(dict(cfg), device="cpu")
        out["accepted"][name] = _raises(lambda: VAEXperiment(model, {}, None))
    ct = build_model(dict(payload["ct"]), device="cpu")
    out["accepted"]["fsdp"] = _raises(
        lambda: VAEXperiment(ct, {"sharding": "fsdp"}, None))
    sp = VAEXperiment(ct, {"sharding": "sp", "model_axis": 3}, None)
    out["refused"]["sp"] = _raises(lambda: sp.setup(), ValueError,
                                   "model_axis 3")
    out["taken"]["model_axis"] = _fsdp_over_a_model_axis(payload)
    out["refused"]["seq_axis"] = _seq_axis_with_block_cols(payload)

    def twin():
        model = build_model(dict(payload["ct"]), device="cpu")
        model.load_state_dict(payload["state_dict"])
        return tstate.create_train_state(
            model, topt.build_optimizers({"LR": 1e-3}, model, 4),
            seed=3, group=group)
    scanned, stepped = twin(), twin()
    stacked = {k: torch.from_numpy(np.stack([v, v]))
               for k, v in payload["batch"].items()}
    multi = tstate.make_multi_train_step("base", 2)
    multi(scanned, stacked)
    one = tstate.make_train_step("base")
    for _ in range(2):
        one(stepped, _tensors(payload["batch"]))
    same = scanned.step == stepped.step == 2 and all(
        torch.equal(t, stepped.model.state_dict()[n])
        for n, t in scanned.model.state_dict().items())
    out["taken"]["scan_steps"] = ("ok" if same and not multi.graphed
                                  else f"equal {same}, graphed "
                                       f"{multi.graphed}")
    exp = VAEXperiment(ct, dict(payload["exp"], dcn_replicas=3), None)
    out["dcn_3"] = _raises(lambda: exp.setup(), ValueError, "dcn_replicas")

    # dcn_replicas 2 against plain dp: the mesh and three steps per mode
    results = {}
    for key, extra in (("dp", {}), ("dcn", {"dcn_replicas": 2})):
        model = build_model(dict(payload["ct"]), device="cpu")
        model.load_state_dict(payload["state_dict"])
        exp = VAEXperiment(model, dict(payload["exp"], **extra), None)
        exp.setup(seed=3)
        results[key + "_mesh"] = (tuple(exp.mesh.mesh_dim_names),
                                  tuple(exp.mesh.mesh.shape))
        for mode in ("base", "action", "causal"):
            for _ in range(2):
                exp._train_step(mode)(exp.state, _tensors(payload["batch"]))
        results[key] = {n: p.detach().clone()
                        for n, p in model.state_dict().items()}
    out["dp_mesh"] = results["dp_mesh"]
    out["dcn_mesh"] = results["dcn_mesh"]
    out["mesh_axes"] = (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS)
    out["dcn_equals_dp"] = all(torch.equal(t, results["dp"][n])
                               for n, t in results["dcn"].items())
    return out


# --- sp_fit: sequence parallelism in the loop, dp over a model axis ----------

def _sp_run(payload, save_dir: str, epochs: int, resume=None):
    """``run.train`` of the payload's config under ``sharding: sp`` for
    ``epochs`` epochs into ``save_dir`` (from ``resume``), with the
    ``seq_axis`` that ``build_model`` got and the target split of its
    model's layers."""
    from ctvae_torch import models, run
    cfg = copy.deepcopy(payload["config"])
    cfg["logging_params"]["save_dir"] = save_dir
    cfg["trainer_params"]["max_epochs"] = epochs
    if resume:
        cfg["trainer_params"]["resume_from_checkpoint"] = resume
    built, saves = [], []
    real, real_save = models.build_model, torch.save

    def spy(model_params, *a, **k):
        built.append(model_params.get("seq_axis"))
        return real(model_params, *a, **k)

    def save_spy(obj, f, *a, **k):
        saves.append(str(f))
        return real_save(obj, f, *a, **k)
    models.build_model, torch.save = spy, save_spy
    try:
        out = run.train(cfg, device="cpu")
    finally:
        models.build_model, torch.save = real, real_save
    return out, built, saves


def case_sp_fit(payload, group) -> Dict[str, Any]:
    """``sharding: dp`` with ``model_axis: 2``: the data module's hosts,
    the first batch and steps of each mode from the setup state.
    ``run.train`` under ``sharding: sp``: one epoch with image grids and
    a metric, a resume for a second, and two epochs straight."""
    from ctvae_torch.parallel import rank
    from ctvae_torch.utils.checkpoint import _load
    out: Dict[str, Any] = {}
    root = payload["root"]
    exp = _experiment(payload, os.path.join(root, f"dp{rank()}"),
                      {"model_axis": 2})
    exp.ckpt.writes = False
    out["dp_mesh"] = (tuple(exp.mesh.mesh_dim_names),
                      tuple(exp.mesh.mesh.shape))
    out["dp_hosts"] = (exp.data.host_id, exp.data.num_hosts)
    out["dp_first"] = next(iter(exp.data.train_dataloader(0)))["image"]
    out["dp_seq_axis"] = exp.model.ct_layer.seq_axis
    for mode in ("base", "action", "causal"):
        exp._train_step(mode)(exp.state, _tensors(payload["batch"]))
    out["dp_params"] = _params(exp)
    if rank() == 0:
        # the same steps in one process: setup's state without a group
        from ctvae_torch.models import build_model
        from ctvae_torch.training import optimizers as topt
        from ctvae_torch.training import state as tstate
        model = build_model(dict(payload["cfg"]), device="cpu",
                            generator=torch.Generator().manual_seed(
                                payload["seed"]))
        one = tstate.create_train_state(model, topt.build_optimizers(
            exp.params, model, exp._steps_per_epoch()), payload["seed"])
        for mode in ("base", "action", "causal"):
            tstate.make_train_step(mode, M_N=exp.kld_weight)(
                one, _tensors(payload["batch"]))
        out["one_params"] = {n: t.detach().clone()
                             for n, t in model.state_dict().items()}
    logs = os.path.join(root, "logs")
    out["first"], out["built"], out["saves"] = _sp_run(payload, logs, 1)
    run_dir = os.path.join(logs, "CTMCQVAE", "version_0")
    last = os.path.join(run_dir, "checkpoints", "last")
    out["second"] = _sp_run(payload, logs, 2, resume=last)[0]
    straight = os.path.join(root, "straight")
    out["straight"] = _sp_run(payload, straight, 2)[0]
    torch.distributed.barrier(group=group)      # rank 0's files are on disk
    out["runs"] = sorted(os.listdir(os.path.join(logs, "CTMCQVAE")))
    out["grids"] = {sub: sorted(os.listdir(os.path.join(run_dir, sub)))
                    for sub in ("Inputs", "Reconstructions", "Samples")}
    resumed = _load(os.path.join(logs, "CTMCQVAE", "version_1",
                                 "checkpoints", "last"))
    whole = _load(os.path.join(straight, "CTMCQVAE", "version_0",
                               "checkpoints", "last"))
    out["resume_differs"] = _differ(resumed, whole)
    return out


def _fsdp_over_a_model_axis(payload) -> str:
    """'ok' when ``VAEXperiment`` under ``sharding: fsdp`` with
    ``model_axis: 2`` sets up on the world of 2 (mesh (data 1, model 2),
    the discoverer's leaves split over ``model``) and a causal step
    gives a finite loss; else what it did."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    model = build_model(dict(payload["ct"]), device="cpu")
    model.load_state_dict(payload["state_dict"])
    exp = VAEXperiment(model, dict(payload["exp"], sharding="fsdp",
                                   model_axis=2, fsdp_min_size=64), None)
    exp.setup(seed=3)
    shape = tuple(exp.mesh.mesh.shape)
    split = set(exp.state.fsdp.model_axes)
    if shape != (1, 2) or not {"ct_layer.disc_w1l", "ct_layer.disc_w1r",
                               "ct_layer.disc_b1"} <= split:
        return f"mesh {shape}, split over model {sorted(split)}"
    loss = exp._train_step("causal")(exp.state,
                                     _tensors(payload["batch"]))["loss"]
    return "ok" if bool(torch.isfinite(loss)) else f"loss {loss}"


def _seq_axis_with_block_cols(payload) -> str:
    """'ok' when a model with ``seq_axis`` and ``gat_block_cols`` below
    its node count builds and, inside a model group of 2, makes the GAT
    calls of the model without ``seq_axis`` (the ``block_cols`` chunks of
    every target: that path is left unsharded, as in JAX) and its
    pairwise calls on the rank's columns, with that model's output; else
    what it did."""
    from ctvae_torch import parallel
    from ctvae_torch.models import build_model
    cfg = dict(payload["ct"], gat_block_cols=8)
    plain = build_model(dict(cfg), device="cpu")
    plain.load_state_dict(payload["state_dict"])
    split = build_model(dict(cfg, seq_axis="model"), device="cpu")
    split.load_state_dict(payload["state_dict"])
    group = parallel.mesh_model_group(parallel.make_mesh(2))
    x = _tensors(payload["batch"])
    from ctvae_torch.models.base import Draws

    def forward(model):
        return model(x["image"], mode="action", action=x["action"],
                     input_y=x["input_y"],
                     draws=Draws(torch.Generator().manual_seed(0)))
    with torch.no_grad():
        with OpShapes() as ref:
            want = forward(plain)
        with parallel.model_parallel(group), OpShapes() as rec:
            got = forward(split)

    def targets(calls, kind):
        return [args[1][1] for name, args, _ in calls
                if name.startswith(kind)]
    gat, cols = targets(rec.calls, "gat"), targets(rec.calls, "pairwise")
    S = payload["ct"]["codebooks"] * (payload["ct"]["img_size"] // 4) ** 2
    if not gat or gat != targets(ref.calls, "gat") or set(cols) != {S // 2}:
        return f"targets per call: gat {gat}, pairwise {cols}"
    if not torch.equal(got["recons"], want["recons"]):
        return "the output differs from the model without seq_axis"
    return "ok"


def case_sp(payload, group, fit_case=None) -> Dict[str, Any]:
    """tests/test_torch_sp.py's two ranks: ``case_steps`` of the payload's
    ``gen`` models, ``case_sp_fit`` (or ``fit_case``) of its ``fit``, on
    rank 0 ``gen``'s ``single`` runs, then ``case_steps`` of the models in
    ``replay`` (a payload the test writes once JAX's traces have recorded
    their draws)."""
    out = {"gen": case_steps({"models": payload["gen"]["models"]}, group),
           "fit": (fit_case or case_sp_fit)(payload["fit"], group)}
    # the one-process references while JAX's traces run (rank 1 waits at
    # the replays' first collective)
    out["single"] = case_steps({**payload["gen"], "models": {}},
                               group).get("single")
    out["replay"] = case_steps(_wait_load(payload["replay"]), group)
    return out


def case_fsdp_tp(payload, group) -> Dict[str, Any]:
    """tests/test_torch_fsdp_tp.py's two ranks: ``case_sp`` with
    ``case_fsdp_tp_fit``."""
    return case_sp(payload, group, case_fsdp_tp_fit)


CASES = {"steps": case_steps, "fit": case_fit, "misc": case_misc,
         "fsdp_fit": case_fsdp_fit, "sp": case_sp, "fsdp_tp": case_fsdp_tp}


def _wait_load(path: str):
    """``torch.load`` of ``path`` once it exists (a payload may be written
    after the ranks start; the writer renames it into place whole)."""
    while not os.path.exists(path):
        time.sleep(0.02)
    return torch.load(path, weights_only=False)


def main(argv: Optional[List[str]] = None) -> int:
    case, r, world, port, payload_path, out_dir = (argv or sys.argv[1:])
    torch.set_num_threads(1)
    from ctvae_torch.parallel import destroy, init_distributed
    group = init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             rank=int(r), world_size=int(world),
                             timeout_s=120)
    out_path = os.path.join(out_dir, f"rank{r}.pt")
    try:
        payload = _wait_load(payload_path)
        result = CASES[case](payload, group)
        torch.save({"ok": True, "result": result}, out_path)
    except BaseException:                   # reported to the test
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    # run the module's own copy: the payload's pickles name its classes
    # (GammaSlot) by the module, not by __main__
    import torch_dp_ranks
    sys.exit(torch_dp_ranks.main())
