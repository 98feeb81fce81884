"""VAEXperiment: the training loop of the port.

Counterpart of ``ctvae_tpu/training/experiment.py``: ``setup`` builds the
optimizers from ``exp_params`` and the train state; ``train_epoch`` runs
one train step per batch of the data module's mode-homogeneous schedule
(one step function per mode), the learning rate read per optimizer update
from the schedule; ``validate`` averages the eval step's scalars over the
validation batches under ``val_`` keys; ``fit`` alternates the two.

Not ported yet (ROADMAP A2): checkpoints and restore, the disentanglement
metrics, image grids, ``scan_steps`` (its GPU analogue is a CUDA graph),
the hang watchdog, sharded or multi-device training and a logger. The
``exp_params`` keys that ask for them raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .optimizers import build_lr_schedules, build_optimizers
from .state import TrainState, create_train_state, make_eval_step, \
    make_train_step

#: exp_params keys of the JAX trainer the port does not take yet, with the
#: values that leave them off
NOT_PORTED = {"scan_steps": (None, 0, 1), "sharding": (None, "dp"),
              "metrics": (None, [], ()), "watch_gradients": (None, 0),
              "profile": (None, "", False), "dcn_replicas": (None, 1),
              "model_axis": (None, 1), "async_checkpointing": (None, False)}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Numpy batch (the ``mode`` string popped) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


class VAEXperiment:

    def __init__(self, model: nn.Module, exp_params: Dict[str, Any],
                 datamodule):
        bad = [k for k, off in NOT_PORTED.items()
               if exp_params.get(k) not in off]
        if bad:
            raise NotImplementedError(f"exp_params {bad} not ported yet "
                                      f"(ROADMAP A2)")
        self.model = model
        self.params = dict(exp_params)
        self.data = datamodule
        self.state: Optional[TrainState] = None
        self.lr_schedules = None
        self._train_steps: Dict[str, Any] = {}
        self._eval_steps: Dict[str, Any] = {}
        self.global_step = 0
        self.seed = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def setup(self, seed: int = 0) -> TrainState:
        spe = self.data.steps_per_epoch() if self.data else 1
        optimizers = build_optimizers(self.params, self.model, spe)
        self.lr_schedules = build_lr_schedules(self.params, spe)
        self.seed = seed
        self.state = create_train_state(self.model, optimizers, seed)
        return self.state

    def _train_step(self, mode: str):
        if mode not in self._train_steps:
            self._train_steps[mode] = make_train_step(mode)
        return self._train_steps[mode]

    def _eval_step(self, mode: str):
        if mode not in self._eval_steps:
            self._eval_steps[mode] = make_eval_step(mode, self.seed)
        return self._eval_steps[mode]

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One step per batch; returns the last batch's scalar metrics (as
        the JAX trainer does), the learning rate and images per second."""
        assert self.state is not None, "call setup() first"
        t0 = time.perf_counter()
        images, metrics, modes = 0, None, {}
        for batch in self.data.train_dataloader(epoch):
            mode = batch.pop("mode", "base")
            metrics = self._train_step(mode)(self.state,
                                             to_device(batch, self.device))
            images += int(np.shape(batch["image"])[0])
            modes[mode] = modes.get(mode, 0) + 1
            self.global_step += 1
        if metrics is None:
            raise RuntimeError(f"train epoch {epoch} produced zero batches: "
                               f"raise data_params.limit")
        host = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        host["lr"] = float(self.lr_schedules[0](self.global_step - 1))
        host["images_per_sec"] = images / max(time.perf_counter() - t0, 1e-9)
        host.update({f"steps_{m}": float(n) for m, n in modes.items()})
        return host

    def validate(self, epoch: int) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for batch in self.data.val_dataloader(epoch):
            mode = batch.pop("mode", "base")
            metrics = self._eval_step(mode)(self.state,
                                            to_device(batch, self.device))
            for k, v in metrics.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
                    counts[k] = counts.get(k, 0) + 1
        return {"val_" + k: sums[k] / counts[k] for k in sums}

    def fit(self, max_epochs: int, seed: int = 0) -> Dict[str, float]:
        """Train ``max_epochs`` epochs, validating after each and printing
        one line per epoch; returns the last epoch's train metrics
        (``train_`` keys) and validation metrics (``val_`` keys)."""
        if self.state is None:
            self.setup(seed=seed)
        out: Dict[str, float] = {}
        for epoch in range(max_epochs):
            train = self.train_epoch(epoch)
            out = {**{f"train_{k}": v for k, v in train.items()},
                   **self.validate(epoch)}
            print(f"epoch {epoch}: " + ", ".join(
                f"{k} {v:.5g}" for k, v in sorted(out.items())), flush=True)
        return out
