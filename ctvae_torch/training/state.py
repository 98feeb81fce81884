"""Train state and the per-mode train / eval steps.

Counterpart of ``ctvae_tpu/training/state.py`` (``make_train_step`` /
``make_eval_step``). PyTorch runs eagerly, so a step is a plain function:
forward under ``train``, ``loss_function``, ``backward``, the global
gradient norm over every parameter, then the optimizer. The random draws
of a step come from the state's ``generator`` (advanced by every train
step); the eval step draws from a generator of its own, seeded apart from
the train draws as the JAX package offsets its eval key by ``1 << 20``.

Every ``loss_function`` gets the JAX step's arguments: ``M_N`` (the
train step's constant, ``exp_params.kld_weight`` in the loop; 1.0 in the
eval step), ``step`` (the global step as an int64 tensor on the model's
device, ``TrainState.step_tensor``), ``train``, ``optimizer_idx`` (the
train step's, 0 in the eval step) and the step's ``Draws`` (JAX's
``noise`` key). The train step of ``optimizer_idx`` k steps the state's
optimizer k alone (a model with two optimizers, FactorVAE, takes a step
of each per batch), and every call advances ``TrainState.step`` by one,
as JAX's ``state.step + 1`` does. The forward gets ``step``
too, as JAX's ``model.apply`` does (CategoricalVAE's temperature reads
it; the other models take and ignore it).

An EMA codebook's buffers and BatchNorm's running statistics are written
in place by the train forward (the JAX step's mutable ``vq_stats`` and
``batch_stats``), whatever the optimizers train, and never by the eval
step.

``make_multi_train_step`` is the counterpart of the JAX package's
``lax.scan`` over K steps (``exp_params.scan_steps``): on the card it
replays one captured CUDA graph of the whole step per batch, so a step
costs a few launches from the host instead of about a thousand.

A state with a process ``group`` (``create_train_state(group=...)``,
``parallel/mesh.py``) takes data-parallel steps: each rank holds its
rows of the global batch, draws its rows of the global draws
(``models/base.py::ShardedDraws``), and after ``backward`` the gradients
become the ranks' mean (``all_reduce_grads``) and the step's scalars the
ranks' means, so ``grad_norm``, the per-module norms and the update are
those of one process on the global batch, on every rank alike. Over
NCCL a multi-step call captures the reductions into its graph; over a
gloo group of more than one rank (whose collectives a CUDA graph cannot
hold) it runs its steps eagerly.

A state with a ``model_group`` (the ranks along the mesh's ``model`` axis,
which hold the same rows) runs its forward inside ``model_parallel``: a
model built with ``seq_axis`` splits its target nodes over that group
(``parallel/sequence.py``), whose sums of the split region's gradients
happen inside ``backward``, so every rank of the group holds the one-
process gradient of its rows before the mean over ``group``.

A state with ``fsdp`` (``parallel/fsdp.py::FSDP``, ``exp_params.
sharding: fsdp``) holds the split parameters as slices: the step
gathers them before the forward, reduce-scatters their gradients to the
slices after the backward and releases the full parameters; its norms
are global (``FSDP.sq_sums``), and ``state_dict`` / ``load_state_dict``
move the full state of one process (a collective under FSDP: every rank
calls them).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models.base import Draws, ShardedDraws
from ..ops import launch_counts, set_launch_counts
from ..parallel.mesh import (all_mean, all_reduce_grads, batch_parallel,
                             group_size, model_parallel)

#: batch keys a forward takes besides the image (ConditionalVAE reads
#: ``labels``; the other models take and ignore what they do not use)
FWD_KEYS = ("labels", "action", "input_y")

EVAL_SEED_OFFSET = 1 << 20


@dataclass
class TrainState:
    """All training state: the global ``step``, the ``model`` (whose
    parameters are the trained state), its ``optimizers``, the
    ``generator`` of the train steps' random draws, the process
    ``group`` the batch is split over (None: one process), the
    ``model_group`` of ranks that hold the same rows (None: no model
    axis) and, under FSDP, the ``fsdp`` that holds the split parameters'
    slices."""

    step: int
    model: nn.Module
    optimizers: List[Any]
    generator: torch.Generator
    group: Any = None
    fsdp: Any = None
    model_group: Any = None
    _step_buf: Optional[torch.Tensor] = field(default=None, repr=False)

    def step_tensor(self) -> torch.Tensor:
        """``step`` in an int64 scalar on the model's device, the one
        buffer the losses read (a captured graph reads it by address):
        filled here, so call it outside a capture, before each step or
        replay."""
        if self._step_buf is None:
            self._step_buf = torch.zeros((), dtype=torch.int64,
                                         device=self.model.device)
        self._step_buf.fill_(self.step)
        return self._step_buf

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit for bit: the
        parameters (and an EMA codebook's buffers), each optimizer's state,
        the step and the generator. Under FSDP the full ones, gathered
        (every rank calls it)."""
        if self.fsdp is None:
            return {"model": self.model.state_dict(),
                    "optimizers": [o.state_dict() for o in self.optimizers],
                    "step": self.step,
                    "generator": self.generator.get_state()}
        with self.fsdp.full():
            model = self.model.state_dict()
        return {"model": model,
                "optimizers": [self.fsdp.full_optimizer_state(o)
                               for o in self.optimizers],
                "step": self.step, "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["optimizers"]) != len(self.optimizers):
            raise ValueError(f"checkpoint has {len(state['optimizers'])} "
                             f"optimizers, the state {len(self.optimizers)}")
        if self.fsdp is None:
            self.model.load_state_dict(state["model"])
            for opt, saved in zip(self.optimizers, state["optimizers"]):
                opt.load_state_dict(saved)
        else:
            with self.fsdp.materialized():
                self.model.load_state_dict(state["model"])
                self.fsdp.load_full()
            for opt, saved in zip(self.optimizers, state["optimizers"]):
                self.fsdp.load_optimizer_state(opt, saved)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])


def create_train_state(model: nn.Module, optimizers: List[Any],
                       seed: int = 0, group=None, fsdp=None,
                       model_group=None) -> TrainState:
    gen = torch.Generator(model.device).manual_seed(seed)
    return TrainState(step=0, model=model, optimizers=list(optimizers),
                      generator=gen, group=group, fsdp=fsdp,
                      model_group=model_group)


def full_params(state: TrainState):
    """A context in which the model holds its full parameters (under FSDP
    gathered, then released; else nothing to do)."""
    return contextlib.nullcontext() if state.fsdp is None \
        else state.fsdp.full()


def _draws(state: TrainState, generator: torch.Generator) -> Any:
    """A step's draws: the rank's rows of the global draws under a group."""
    draws = Draws(generator, state.model.device)
    return draws if state.group is None else ShardedDraws(draws,
                                                          state.group)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor], mode: str,
             draws: Draws, train: bool, M_N: float, step: torch.Tensor,
             optimizer_idx: int = 0) -> Dict[str, Any]:
    kwargs = {k: batch[k] for k in FWD_KEYS if k in batch}
    outputs = model(batch["image"], mode=mode, draws=draws, train=train,
                    step=step, **kwargs)
    return model.loss_function(outputs, M_N=M_N, step=step, train=train,
                               optimizer_idx=optimizer_idx, draws=draws)


def _scalars(losses: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Numeric entries, detached (strings such as ``mode`` dropped)."""
    return {k: v.detach() for k, v in losses.items()
            if isinstance(v, torch.Tensor)}


def _module_norms(state: TrainState, kind: str, grads: bool
                  ) -> Dict[str, torch.Tensor]:
    """``<kind>/<name>``: the global norm of each top-level module's
    gradients (a parameter without one counts as zero) or parameters, as
    the JAX step's ``watch_modules`` reads them per top-level params key
    (under FSDP from the slices, summed over the ranks)."""
    children = [(name, list(child.parameters()))
                for name, child in state.model.named_children()]
    children = [(name, ps) for name, ps in children if ps]
    if state.fsdp is not None:
        sums = state.fsdp.sq_sums([ps for _, ps in children], grads)
        return {f"{kind}/{name}": torch.sqrt(sums[i])
                for i, (name, _) in enumerate(children)}
    out = {}
    for name, ps in children:
        ts = [p.grad for p in ps if p.grad is not None] if grads else ps
        out[f"{kind}/{name}"] = (global_norm(ts) if ts
                                 else ps[0].new_zeros(()))
    return out


@torch.no_grad()
def _param_norms(state: TrainState) -> Dict[str, torch.Tensor]:
    return _module_norms(state, "param_norm", grads=False)


def _grads(state: TrainState, batch: Dict[str, torch.Tensor], mode: str,
           M_N: float, step: torch.Tensor, optimizer_idx: int = 0
           ) -> Dict[str, torch.Tensor]:
    """The device work of a train step before the optimizer: gradients
    of the loss of ``optimizer_idx`` in ``p.grad`` and the step's metrics
    with ``grad_norm`` (``step``: ``state.step_tensor()``, filled before
    the call)."""
    model = state.model
    if state.fsdp is not None:
        state.fsdp.gather()
    model.zero_grad(set_to_none=True)
    with batch_parallel(state.group), model_parallel(state.model_group):
        losses = _forward(model, batch, mode, _draws(state, state.generator),
                          train=True, M_N=M_N, step=step,
                          optimizer_idx=optimizer_idx)
        losses["loss"].backward()
    metrics = _scalars(losses)
    if state.fsdp is not None:
        # the slices' gradients, then the full parameters go
        state.fsdp.reduce_grads(state.group)
        state.fsdp.release()
        metrics = all_mean(metrics, state.group)
        metrics["grad_norm"] = torch.sqrt(state.fsdp.sq_sums(
            [list(model.parameters())], grads=True)[0])
        return metrics
    if state.group is not None:
        # every gradient, trained or not: grad_norm covers them all
        all_reduce_grads(model.parameters(), state.group)
        metrics = all_mean(metrics, state.group)
    # over every parameter, trained or not (optax.global_norm of the
    # whole gradient tree); an unused parameter's gradient is zero
    metrics["grad_norm"] = global_norm(
        p.grad for p in model.parameters() if p.grad is not None)
    return metrics


def make_train_step(mode: str, watch_modules: bool = False,
                    M_N: float = 1.0, optimizer_idx: int = 0
                    ) -> Callable[[TrainState, Dict], Dict]:
    """The train step of batch mode ``mode``: ``step(state, batch)``
    updates ``state`` in place (parameters, buffers, the state of
    optimizer ``optimizer_idx``, ``step``) and returns the loss terms of
    ``optimizer_idx``, the model's metrics and ``grad_norm``; ``M_N`` is
    the losses' KL weight. ``watch_modules`` adds ``grad_norm/<module>``
    and, after the update, ``param_norm/<module>`` for each top-level
    module (the JAX step's ``watch_modules``)."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        metrics = _grads(state, batch, mode, M_N, state.step_tensor(),
                         optimizer_idx)
        if watch_modules:           # the gradients before the clip
            metrics.update(_module_norms(state, "grad_norm", True))
        state.optimizers[optimizer_idx].step()
        if watch_modules:
            metrics.update(_param_norms(state))
        state.step += 1
        return metrics

    return step_fn


#: eager steps of a batch shape before its graph is captured; they create
#: Adam's moments and the libraries' workspaces, which a capture must not
WARMUP_STEPS = 3


class _Graph:
    """One train step of one batch shape captured as a CUDA graph: the
    input buffers it reads, the metrics it writes, and the kernel
    launches of the port's wrappers it holds (one replay makes them all
    again)."""

    def __init__(self, graph, inputs, metrics, launches):
        self.graph, self.inputs, self.metrics = graph, inputs, metrics
        self.launches = launches
        self.replays = 0


def _bound(state: TrainState) -> Tuple:
    """What a captured graph reads and writes by address: the model, the
    generator, the one optimizer and its state (Adam's moments, the LR and
    divisor scalars, the accumulation's buffers; changed by a load)."""
    opt = state.optimizers[0]
    return (state.model, state.generator, opt, opt.version)


class MultiTrainStep:
    """``n_steps`` train steps of ``mode`` per call, the counterpart of
    ``ctvae_tpu/training/state.py::make_multi_train_step``.

    ``step(state, batches)`` takes a batch dict whose every leaf is
    stacked ``[n_steps, B, ...]``, runs the steps in order and returns
    the last step's metrics; the state afterwards (parameters, optimizer
    state, ``step``, generator) is what ``n_steps`` calls of
    ``make_train_step(mode)`` leave.

    On the CPU that is the loop of those calls, and on the card too where
    the state's batch or model group is a gloo group of more than one
    rank: a CUDA graph cannot hold gloo's collectives, so the K steps run
    as an eager loop with the values of K single steps. Else, on the
    card, the first ``WARMUP_STEPS`` steps of a batch shape (and with
    ``accumulate_grad_batches`` k > 1 any more until the optimizer has
    made its first update, which creates Adam's moments) run eagerly on a
    side stream; then the step is captured into CUDA graphs that read
    static input buffers: one graph of the whole step (gradients,
    ``grad_norm``, the optimizer's update), or with k > 1 two, an
    *accumulate* graph (gradients, the running mean, no update) and an
    *apply* graph (gradients, the mean into ``p.grad``, the clip, Adam,
    the mean's buffers zeroed). Every later step copies its batch into the
    buffers, fills the optimizer's accumulation divisor and LR, chooses
    the graph by the host's ``mini_step`` (apply at the k-th) and replays
    it, so the phases run on across calls whatever K and k are, and only
    an apply advances ``count`` (the schedule counts updates, as JAX's
    ``MultiSteps`` does). The train generator is registered with the
    graphs, so each replay advances it as an eager step does. A failed
    capture raises. The graphs hold the train state by address: a call
    with another state, or after a load of its optimizers' state, raises
    (make a new ``MultiTrainStep``).

    ``graphed`` says whether the last call replayed a graph (False after
    an eager loop, before the first capture or during the warm-up);
    ``replays`` counts the replays; ``replayed_launches()`` the port's
    kernel launches they made (counted at capture: the wrappers' counters
    do not tick on replay)."""

    def __init__(self, mode: str, n_steps: int, watch_modules: bool = False,
                 M_N: float = 1.0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be at least 1, got {n_steps}")
        self.mode, self.n_steps = mode, n_steps
        self.watch_modules, self.M_N = watch_modules, M_N
        self.replays = 0
        self.graphed = False
        self._step = make_train_step(mode, watch_modules, M_N)
        self._bound: Optional[Tuple] = None
        # per batch shape: the graph of each phase ("apply", "accumulate")
        self._graphs: Dict[Tuple, Dict[str, _Graph]] = {}
        self._warm: Dict[Tuple, int] = {}    # eager steps per batch shape

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by the replays so far, by kernel name."""
        out: Dict[str, int] = {}
        for graphs in self._graphs.values():
            for g in graphs.values():
                for k, n in g.launches.items():
                    out[k] = out.get(k, 0) + n * g.replays
        return out

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        bad = {k: tuple(v.shape) for k, v in batches.items()
               if v.dim() == 0 or v.shape[0] != self.n_steps}
        if bad:
            raise ValueError(f"batch leaves must be stacked [{self.n_steps}, "
                             f"B, ...], got {bad}")
        batch = [{k: v[i] for k, v in batches.items()}
                 for i in range(self.n_steps)]
        if len(state.optimizers) != 1:
            raise ValueError("a multi-step train step takes a state with "
                             "one optimizer: a model with two alternates "
                             "them per batch (make_train_step's "
                             "optimizer_idx)")
        self.graphed = False
        over_gloo = any(g is not None and group_size(g) > 1 and
                        torch.distributed.get_backend(g) != "nccl"
                        for g in (state.group, state.model_group))
        if state.model.device.type != "cuda" or over_gloo:
            for b in batch:
                metrics = self._step(state, b)
            return metrics
        bound = _bound(state)
        if self._bound is None:
            self._bound = bound
        elif any(a is not b and a != b for a, b in zip(bound, self._bound)):
            raise ValueError("this multi-step train step holds graphs of "
                             "another train state (or of its optimizer's "
                             "state before a load): make a new one")
        opt = state.optimizers[0]
        key = tuple((k, tuple(v.shape[1:]), v.dtype)
                    for k, v in sorted(batches.items()))
        graphs = self._graphs.get(key)
        i = 0
        if graphs is None:
            # eager warm-up steps on a side stream
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                while i < len(batch) and (
                        self._warm.get(key, 0) < WARMUP_STEPS
                        or not opt.started()):
                    metrics = self._step(state, batch[i])
                    self._warm[key] = self._warm.get(key, 0) + 1
                    i += 1
            torch.cuda.current_stream().wait_stream(side)
            if i == len(batch):
                return metrics
            graphs = self._graphs[key] = self._capture(state, batch[i])
        for b in batch[i:]:
            apply = opt.mini_step + 1 >= opt.accumulate
            g = graphs["apply" if apply else "accumulate"]
            for name, buf in g.inputs.items():
                buf.copy_(b[name])
            opt.set_div()
            if apply:
                opt.set_lr()
            state.step_tensor()
            g.graph.replay()
            if apply:
                opt.count += 1
                opt.mini_step = 0
            else:
                opt.mini_step += 1
            state.step += 1
            g.replays += 1
            self.replays += 1
        self.graphed = True
        return {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, _Graph]:
        """Capture the step's graphs (``apply``, and with accumulation
        ``accumulate``) reading one set of copies of ``batch``. A capture
        runs the step's Python once and no work on the card, so the
        kernels' launch counters are put back."""
        inputs = {k: v.clone() for k, v in batch.items()}
        opt = state.optimizers[0]
        opt.set_lr()                # the group reads the LR tensor
        step = state.step_tensor()  # and the losses the step's
        phases = ("apply",)
        if opt.accumulate > 1:
            opt.acc_buffers()       # made outside the graphs' memory
            phases = ("accumulate", "apply")
        return {ph: self._capture_one(state, inputs, step, ph == "apply")
                for ph in phases}

    def _capture_one(self, state: TrainState, inputs, step: torch.Tensor,
                     apply: bool) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = launch_counts()
        try:
            with torch.cuda.graph(graph):
                metrics = _grads(state, inputs, self.mode, self.M_N, step)
                if self.watch_modules:
                    metrics.update(_module_norms(state, "grad_norm", True))
                opt = state.optimizers[0]
                if opt.accumulate > 1:
                    opt.accumulate_grads()
                    if apply:
                        opt.take_mean()
                if apply:
                    opt.update()
                if self.watch_modules:
                    metrics.update(_param_norms(state))
        finally:
            after = launch_counts()
            set_launch_counts(before)
        return _Graph(graph, inputs, metrics,
                      {k: after[k] - before[k] for k in after})


def make_multi_train_step(mode: str, n_steps: int,
                          watch_modules: bool = False, M_N: float = 1.0
                          ) -> MultiTrainStep:
    """``n_steps`` train steps of batch mode ``mode`` per call, on batches
    stacked ``[n_steps, B, ...]`` (``MultiTrainStep``); ``watch_modules``
    and ``M_N`` as in ``make_train_step`` (in a captured graph the norms
    are outputs of the graph)."""
    return MultiTrainStep(mode, n_steps, watch_modules, M_N)


def make_eval_step(mode: str, seed: int = 0
                   ) -> Callable[[TrainState, Dict], Dict]:
    """The validation step of batch mode ``mode``: forward with
    ``train=False`` and the loss at ``M_N=1.0``, no gradient; its draws
    come from a generator of its own, seeded ``seed + (1 << 20)``. Under
    a group its metrics are the ranks' means, as the train step's; under
    FSDP it gathers the parameters (and releases them after)."""
    generator = None

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        nonlocal generator
        device = state.model.device
        if generator is None:
            generator = torch.Generator(device).manual_seed(
                seed + EVAL_SEED_OFFSET)
        with batch_parallel(state.group), \
                model_parallel(state.model_group), full_params(state):
            metrics = _scalars(_forward(state.model, batch, mode,
                                        _draws(state, generator),
                                        train=False, M_N=1.0,
                                        step=state.step_tensor()))
        return metrics if state.group is None else all_mean(metrics,
                                                            state.group)

    return step_fn
