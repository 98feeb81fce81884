"""VAEXperiment: the training loop of the port.

Counterpart of ``ctvae_tpu/training/experiment.py``: ``setup`` builds the
optimizers from ``exp_params`` and the train state; ``exp_params.
kld_weight`` (default 1.0) is the train steps' ``M_N``, validation's is
1.0; ``train_epoch`` runs
one train step per batch of the data module's mode-homogeneous schedule
(one step function per mode; batches reach the device through
``data/prefetch.py``), the learning rate read per optimizer update from
the schedule; ``validate`` averages the eval step's scalars over the
validation batches under ``val_`` keys; ``fit`` alternates the two from
``start_epoch``, writes the ``Inputs`` / ``Reconstructions`` / ``Samples``
grids of each epoch (``sample_images``) and, with a ``CheckpointManager``,
saves after each validation. With an ``ExperimentLogger`` the train
metrics and learning rate go to it every ``log_every`` steps, and the
epoch, images per second and validation scalars once per epoch.
``install_preemption_handler`` turns SIGTERM into a ``last`` checkpoint
and a stop at the next epoch boundary. ``restore_full_state`` resumes a
run bit for bit; ``load_weights`` is the weights-only restore of the
two-stage recipe.

``exp_params.scan_steps`` K > 1 runs each K consecutive batches of one
mode and shape as one ``make_multi_train_step`` call (on the card, K
replays of a captured CUDA graph); a mode switch, a shape change or the
epoch's end runs what is buffered as per-step calls.

A model with two optimizers (``exp_params.LR_2``: FactorVAE) takes, per
batch, the train step of optimizer 0 and then that of optimizer 1, step
by step (``scan_steps`` is ignored, as in JAX); ``global_step`` counts
batches, ``TrainState.step`` optimizer calls, and the logger writes
``lr`` and ``lr_2``. ``setup`` loads pretrained weights into a frozen
VGG (DFCVAE's) and, without them, refuses to train unless the model's
``allow_random_features`` is set (``models/vgg.py::
attach_pretrained_vgg``). ``exp_params.retain_first_backpass`` (the
reference's FactorVAE flag) is accepted and ignored: one forward serves
both optimizers' losses.

The loop's services: ``val_metrics`` (a ``metrics.MetricSet``) adds the
disentanglement metrics of ``repr_fn`` (the encoder's first output,
flattened) to each validation under ``val_``; ``exp_params.
watch_gradients`` N > 0 logs ``grad_norm/<module>`` and
``param_norm/<module>`` of each top-level module every N steps;
``exp_params.profile: <dir>`` writes a ``torch.profiler`` trace of epoch 0
there; ``fit`` waits for an asynchronous checkpoint write
(``CheckpointManager(async_save=True)``) before it returns or reports a
stop.

Data parallelism (``exp_params.sharding: dp``, the default; ``parallel/
mesh.py``): where a process group is up, ``setup`` builds the mesh
(``dcn_replicas`` N > 1: the hybrid ``(replica, data, model)`` mesh, N
dividing the world), splits the batch over every rank, broadcasts the
state from rank 0 and takes data-parallel steps; ``fit`` ORs the stop
request over the ranks; ``validate`` reports the means over the global
batches (the eval step's metrics are the ranks' means); only rank 0 writes checkpoints, image grids, logs and the epoch
line; every rank restores. A loss that is not a mean of per-row terms
takes its cross-batch term on the global batch (``parallel/mesh.py::
gather_batch``), so every registry model trains at any world.

``exp_params.sharding: fsdp`` (with ``fsdp_min_size``, default 4,096
elements, and composed with ``dcn_replicas``) adds ZeRO-3
(``parallel/fsdp.py``): ``setup`` splits the parameters of
``fsdp_plan`` over the mesh's ``data`` axis after the broadcast and
builds the optimizers over the slices, so Adam's moments are born
split; ``restore_full_state`` and ``load_weights`` take a full state
into the slices, checkpoints hold the full state (rank 0 writes what
every rank gathered), and validation and the image grids run on the
gathered parameters. Without a process group (one process) nothing is
split, as the JAX trainer splits nothing over a data axis of 1. Not
ported yet (ROADMAP A8): ``sharding: sp`` and ``model_axis`` > 1, which
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.prefetch import to_device
from ..models.base import Draws
from ..models.vgg import attach_pretrained_vgg
from ..parallel.fsdp import fully_shard
from ..parallel.mesh import (FSDP_MIN_SIZE, global_any, is_primary,
                             make_hybrid_mesh, make_mesh, mesh_batch_group,
                             mesh_data_group, mesh_replica_group,
                             put_replicated, shard_batch)
from ..serving.inference import encode_repr
from ..utils.checkpoint import CheckpointManager, load_weights_only
from .optimizers import build_lr_schedules, build_optimizers
from .state import FWD_KEYS, TrainState, create_train_state, \
    full_params, make_eval_step, make_multi_train_step, make_train_step

#: exp_params keys of the JAX trainer the port does not take yet, with the
#: values that leave them off
NOT_PORTED = {"sharding": (None, "dp", "fsdp"), "model_axis": (None, 1)}


def _is_watch_key(k: str) -> bool:
    """The per-module norms of ``watch_gradients``, logged on their own
    cadence."""
    return k.startswith(("grad_norm/", "param_norm/"))


def make_repr_fn(model: nn.Module):
    """The representation of the metrics: observations [B, H, W, C]
    (numpy or torch; uint8 is divided by 255) -> the first output of
    ``model.encode`` flattened in its NHWC order (the first array of a
    nested one: LVAE's lowest rung's mu), [B, D] on the model's device,
    without gradients (``ctvae_tpu``'s ``VAEXperiment.repr_fn``). An
    encoder that draws (HVAE) draws from a generator seeded 0 afresh at
    each call, as JAX's ``repr_fn`` passes the same fixed keys to every
    call."""

    @torch.no_grad()
    def fn(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(model.device)
        x = (x.float() / 255.0 if x.dtype == torch.uint8 else x.float())
        draws = (Draws(torch.Generator(model.device).manual_seed(0),
                       model.device)
                 if getattr(model, "stochastic_encode", False) else None)
        return encode_repr(model, x, draws)

    return fn


__all__ = ["VAEXperiment", "install_preemption_handler", "make_repr_fn"]


def install_preemption_handler(experiment: "VAEXperiment", signals=None):
    """Route SIGTERM (or ``signals``) to ``experiment.request_stop``: the
    run saves ``last`` at the next epoch boundary and stops. Returns the
    handlers it replaced, by signal, for the caller to put back."""
    import signal

    def handler(signum, frame):
        experiment.request_stop()

    return {s: signal.signal(s, handler)
            for s in (signals or (signal.SIGTERM,))}


class VAEXperiment:

    def __init__(self, model: nn.Module, exp_params: Dict[str, Any],
                 datamodule, logger=None,
                 ckpt_manager: Optional[CheckpointManager] = None,
                 val_metrics=None, train_metrics=None, log_every: int = 50):
        bad = [k for k, off in NOT_PORTED.items()
               if exp_params.get(k) not in off]
        if bad:
            raise NotImplementedError(f"exp_params {bad} not ported yet "
                                      f"(ROADMAP A8)")
        self.sharding = str(exp_params.get("sharding") or "dp")
        self.fsdp_min_size = int(exp_params.get("fsdp_min_size")
                                 or FSDP_MIN_SIZE)
        self.dcn_replicas = int(exp_params.get("dcn_replicas") or 1)
        self.mesh = None
        self.group = None
        self.model = model
        self.params = dict(exp_params)
        self.data = datamodule
        self.logger = logger
        self.ckpt = ckpt_manager
        self.val_metrics = val_metrics
        self.train_metrics = train_metrics
        self.log_every = log_every
        self.watch_every = int(exp_params.get("watch_gradients", 0) or 0)
        self.kld_weight = float(exp_params.get("kld_weight", 1.0))
        self._stop_requested = False
        self.state: Optional[TrainState] = None
        self.lr_schedules = None
        self._train_steps: Dict[str, Any] = {}
        self._multi_steps: Dict[str, Any] = {}
        self._eval_steps: Dict[str, Any] = {}
        self.scan_steps = max(1, int(exp_params.get("scan_steps", 1) or 1))
        self.global_step = 0
        self.start_epoch = 0
        self.seed = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _steps_per_epoch(self) -> int:
        return max(1, self.data.steps_per_epoch() if self.data else 1)

    def setup(self, seed: int = 0) -> TrainState:
        attach_pretrained_vgg(self.model, allow_random=bool(getattr(
            self.model, "allow_random_features", False)))
        spe = self._steps_per_epoch()
        self.lr_schedules = build_lr_schedules(self.params, spe)
        self.seed = seed
        if torch.distributed.is_initialized():
            dtype = getattr(self.model, "compute_dtype", torch.float32)
            if dtype != torch.float32:
                raise NotImplementedError(
                    f"not ported yet: sharding {self.sharding!r} over "
                    f"ranks of a model at {dtype} (ROADMAP A6)")
            self.mesh = (make_hybrid_mesh(self.dcn_replicas)
                         if self.dcn_replicas > 1 else make_mesh())
            self.group = mesh_batch_group(self.mesh)
        elif self.dcn_replicas > 1:
            raise ValueError(f"dcn_replicas {self.dcn_replicas} needs a "
                             f"process group of a world it divides")
        self.state = create_train_state(self.model, [], seed,
                                        group=self.group)
        put_replicated(self.model, self.group, self.state.generator)
        if self.sharding == "fsdp" and self.group is not None:
            # after the broadcast, so every rank slices equal parameters,
            # and before the optimizers, whose moments are born split
            self.state.fsdp = fully_shard(
                self.model, mesh_data_group(self.mesh),
                mesh_replica_group(self.mesh), self.fsdp_min_size)
        self.state.optimizers = build_optimizers(self.params, self.model,
                                                 spe, fsdp=self.state.fsdp)
        return self.state

    def restore_full_state(self, which: str = "last") -> None:
        """Full-state resume: parameters, optimizer states, the step, the
        train generator, and the epoch position (``step // steps per
        epoch``), so a resumed ``fit`` trains to ``max_epochs`` in all."""
        assert self.state is not None and self.ckpt is not None
        self.state.load_state_dict(self.ckpt.restore(which))
        self._multi_steps.clear()       # their graphs hold the old state
        # the state counts optimizer calls, the loop batches
        self.global_step = self.state.step // len(self.state.optimizers)
        self.start_epoch = self.global_step // self._steps_per_epoch()

    def load_weights(self, ckpt_path: str) -> None:
        """Weights-only restore: the checkpoint's parameters that the
        model has by name and shape; the optimizer states start fresh."""
        assert self.state is not None, "call setup() first"
        fsdp = self.state.fsdp
        if fsdp is None:
            load_weights_only(ckpt_path, self.model)
        else:
            # the parameters the checkpoint does not hold keep their values
            with fsdp.full():
                load_weights_only(ckpt_path, self.model)
                fsdp.load_full()
        self.state.optimizers = build_optimizers(
            self.params, self.model, self._steps_per_epoch(), fsdp=fsdp)
        self._multi_steps.clear()

    def _train_step(self, mode: str, optimizer_idx: int = 0):
        key = (mode, optimizer_idx)
        if key not in self._train_steps:
            self._train_steps[key] = make_train_step(
                mode, watch_modules=self.watch_every > 0, M_N=self.kld_weight,
                optimizer_idx=optimizer_idx)
        return self._train_steps[key]

    def _multi_train_step(self, mode: str):
        if mode not in self._multi_steps:
            self._multi_steps[mode] = make_multi_train_step(
                mode, self.scan_steps, watch_modules=self.watch_every > 0,
                M_N=self.kld_weight)
        return self._multi_steps[mode]

    def _eval_step(self, mode: str):
        if mode not in self._eval_steps:
            self._eval_steps[mode] = make_eval_step(mode, self.seed)
        return self._eval_steps[mode]

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One step per batch (per optimizer, in order, with two); returns
        the last step's scalar metrics (as
        the JAX trainer does), the learning rate and images per second.
        With ``scan_steps`` K > 1, K consecutive batches of one mode and
        shape run as one multi-step call; a mode switch, a shape change
        or the epoch's end runs the shorter remainder step by step."""
        assert self.state is not None, "call setup() first"
        t0 = time.perf_counter()
        images, metrics, modes = 0, None, {}
        pending: list = []
        pend_mode: Optional[str] = None
        n_opt = len(self.state.optimizers)
        scan_k = self.scan_steps if n_opt == 1 else 1

        def flush():
            nonlocal metrics, images
            if not pending:
                return
            if len(pending) == scan_k > 1:
                metrics = self._multi_train_step(pend_mode)(
                    self.state, {k: torch.stack([b[k] for b in pending])
                                 for k in pending[0]})
            else:
                for b in pending:
                    for i in range(n_opt):
                        metrics = self._train_step(pend_mode, i)(
                            self.state, b)
            images += sum(int(b["image"].shape[0]) for b in pending)
            modes[pend_mode] = modes.get(pend_mode, 0) + len(pending)
            self.global_step += len(pending)
            self._log_train(metrics, len(pending))
            pending.clear()

        for batch in self.data.train_dataloader(epoch):
            mode = batch.pop("mode", "base")
            batch = shard_batch(batch, self.device)
            if pending and (mode != pend_mode or batch["image"].shape
                            != pending[0]["image"].shape):
                flush()     # a mode switch or the epoch tail's batch size
            pend_mode = mode
            pending.append(batch)
            if len(pending) == scan_k:
                flush()
        flush()
        if metrics is None:
            raise RuntimeError(f"train epoch {epoch} produced zero batches: "
                               f"raise data_params.limit")
        host = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        for i, sched in enumerate(self.lr_schedules):
            host["lr" if i == 0 else f"lr_{i + 1}"] = float(
                sched(self.global_step - 1))
        host["images_per_sec"] = images / max(time.perf_counter() - t0, 1e-9)
        host.update({f"steps_{m}": float(n) for m, n in modes.items()})
        return host

    def _log_train(self, metrics: Dict[str, torch.Tensor], n_new: int
                   ) -> None:
        """Step-cadence logging, once per executed block: the block's last
        metrics and each optimizer's learning rate when a step of the block
        crossed a multiple of ``log_every``; the ``watch_gradients`` norms
        when one crossed a multiple of that."""
        if self.logger is None:
            return
        at_log = self.global_step % self.log_every < n_new
        at_watch = bool(self.watch_every) and \
            self.global_step % self.watch_every < n_new
        if not (at_log or at_watch):
            return
        logged = {k: v.detach().cpu().numpy() for k, v in metrics.items()
                  if (at_watch if _is_watch_key(k) else at_log)}
        if at_log:
            for i, sched in enumerate(self.lr_schedules):
                logged["lr" if i == 0 else f"lr_{i + 1}"] = np.float32(
                    sched(self.global_step))
        self.logger.log_all(logged, self.global_step)

    def validate(self, epoch: int) -> Dict[str, float]:
        """The eval step's scalars averaged over the validation batches
        and the ``val_metrics``, under ``val_`` keys (under FSDP on the
        gathered parameters)."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        with full_params(self.state):
            for batch in self.data.val_dataloader(epoch):
                mode = batch.pop("mode", "base")
                batch = shard_batch(batch, self.device)
                metrics = self._eval_step(mode)(self.state, batch)
                for k, v in metrics.items():
                    if v.dim() == 0:
                        sums[k] = sums.get(k, 0.0) + float(v)
                        counts[k] = counts.get(k, 0) + 1
            out = {"val_" + k: sums[k] / counts[k] for k in sums}
            if self.val_metrics is not None:
                out.update({"val_" + k: v for k, v in
                            self.val_metrics.compute(self.repr_fn).items()})
        if self.logger is not None:
            self.logger.log_all(out, self.global_step)
        return out

    def fit(self, max_epochs: int, seed: int = 0,
            sample_dir: Optional[str] = None) -> Dict[str, float]:
        """Train from ``start_epoch`` to ``max_epochs``, validating after
        each epoch, writing the epoch's image grids under ``sample_dir``
        when given, saving a checkpoint with the validation metrics when a
        manager is set, and printing one line per epoch; returns the last
        epoch's train metrics (``train_`` keys) and validation metrics
        (``val_`` keys). A stop request (``request_stop``) saves ``last``
        after the current epoch's training and returns."""
        if self.state is None:
            self.setup(seed=seed)
        profile_dir = self.params.get("profile")
        out: Dict[str, float] = {}
        try:
            for epoch in range(self.start_epoch, max_epochs):
                if profile_dir and epoch == 0:
                    train = self._profiled_epoch(epoch, str(profile_dir))
                else:
                    train = self.train_epoch(epoch)
                if self._global_stop():
                    if self.ckpt is not None:
                        self.ckpt.save(self.state, self.global_step)
                        # report the stop only once the write is on disk
                        self.ckpt.wait()
                    if is_primary():
                        print(f"=> stop requested: saved checkpoint at step "
                              f"{self.global_step} (epoch {epoch}); resume "
                              f"with trainer_params.resume_from_checkpoint",
                              flush=True)
                    break
                # every rank gathers (a collective), rank 0 samples
                with full_params(self.state):
                    val = self.validate(epoch)
                    if sample_dir is not None and is_primary():
                        self.sample_images(sample_dir, epoch)
                if self.ckpt is not None:
                    self.ckpt.save(self.state, self.global_step, metrics=val)
                if self.logger is not None:
                    self.logger.add_scalar("epoch", epoch, self.global_step)
                    self.logger.add_scalar("images_per_sec",
                                           train["images_per_sec"],
                                           self.global_step)
                out = {**{f"train_{k}": v for k, v in train.items()}, **val}
                if is_primary():
                    print(f"epoch {epoch}: " + ", ".join(
                        f"{k} {v:.5g}" for k, v in sorted(out.items())),
                        flush=True)
        finally:
            if self.ckpt is not None:
                # an asynchronous write in flight ends before fit does,
                # also when the loop raised
                self.ckpt.wait()
        return out

    def _profiled_epoch(self, epoch: int, out_dir: str) -> Dict[str, float]:
        """``train_epoch`` under ``torch.profiler`` (the card's kernels
        too, where there is one); the trace goes to ``out_dir``/
        ``epoch_<epoch>.pt.trace.json`` (Chrome trace format)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            train = self.train_epoch(epoch)
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(out_dir, f"epoch_{epoch}.pt.trace.json"))
        return train

    @property
    def repr_fn(self):
        """``make_repr_fn`` of the model: the metrics' representation."""
        return make_repr_fn(self.model)

    def _global_stop(self) -> bool:
        """The stop request of any rank: every rank takes the same branch
        at the epoch boundary (a lone rank leaving the loop would strand
        the others in a collective)."""
        if self.group is None:
            return self._stop_requested
        return global_any(self._stop_requested, self.group)

    def request_stop(self) -> None:
        """Ask ``fit`` to save ``last`` and stop at the next epoch boundary
        (only sets a flag, so a signal handler may call it)."""
        self._stop_requested = True

    def sample_images(self, out_dir: str, epoch: int,
                      num_samples: int = 32) -> None:
        """The first test batch's inputs and reconstructions (``generate``,
        in the batch's mode) and, where the model has a prior (``has_prior``),
        ``num_samples`` decoded random latents (beside the batch's first
        labels for a model that ``needs_labels``), as PNG grids under
        ``out_dir``'s ``Inputs``, ``Reconstructions`` and ``Samples``. The
        epoch seeds the draws, so each epoch's samples are fresh."""
        from ..utils.images import save_image
        batch = next(iter(self.data.test_dataloader(epoch)))
        mode = batch.pop("mode", "base")
        batch = to_device(batch, self.device)
        name = type(self.model).__name__
        draws = Draws(torch.Generator(self.device).manual_seed(epoch),
                      self.device)

        def save(images: torch.Tensor, sub: str, fname: str) -> None:
            save_image(images.cpu().numpy(), os.path.join(out_dir, sub, fname),
                       normalize=True)

        save(batch["image"], "Inputs", f"real_img_{name}_Epoch_{epoch}.png")
        kwargs = {k: batch[k] for k in FWD_KEYS if k in batch}
        with torch.no_grad():
            recons = self.model.generate(batch["image"], mode=mode,
                                         draws=draws, **kwargs)
            save(recons, "Reconstructions", f"recons_{name}_Epoch_{epoch}.png")
            if getattr(self.model, "needs_labels", False):
                # decoded beside the batch's first labels
                labels = batch["labels"][:num_samples]
                save(self.model.sample(len(labels), labels, draws=draws),
                     "Samples", f"{name}_Epoch_{epoch}.png")
            elif hasattr(self.model, "sample"):
                save(self.model.sample(num_samples, draws=draws), "Samples",
                     f"{name}_Epoch_{epoch}.png")
