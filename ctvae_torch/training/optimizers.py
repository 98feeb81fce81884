"""Optimizer construction from ``exp_params``.

Counterpart of ``ctvae_tpu/training/optimizers.py`` (an optax chain there,
``torch.optim.Adam`` with the same steps around it here):

* Adam(LR, weight_decay) whose weight decay is torch's coupled L2
  (``wd * param`` added to the gradient before the moments);
* ``update_parameters``: only the top-level submodules whose name starts
  with it are optimised; every other parameter gets no update and no Adam
  state (its gradient is still computed, so ``grad_norm`` covers it);
* ``scheduler_gamma``: a per-epoch staircase ExponentialLR, read per
  optimizer update (``gamma == 0`` zeroes the LR from the second epoch on,
  as torch does);
* ``gradient_clip_val``: torch's ``clip_grad_norm_`` (``max_norm / (norm +
  1e-6)``) over the optimised parameters, before the weight decay;
* ``accumulate_grad_batches`` k: the running mean of k gradients, one
  optimizer update per k calls (optax ``MultiSteps``); the schedule counts
  updates, not calls.
* ``LR_2`` (adversarial models, FactorVAE): a second Adam(LR_2) with
  weight decay 0 and the same clip over the parameters under the
  top-level submodules named ``submodel...`` (all of them without
  ``submodel``), on its own staircase ``scheduler_gamma_2``; the first
  optimizer keeps every parameter it had (the discriminator too: JAX's
  first transform is unmasked). The train step of ``optimizer_idx`` k
  steps optimizer k alone.

On a CUDA device the update can be captured into a CUDA graph
(``training/state.py::make_multi_train_step``): the learning rate is a
device tensor, filled from the schedule before each update outside any
graph, and Adam runs with ``capturable=True`` (its step count on the
device too). The eager update on the card runs the same arithmetic, so a
replayed graph and eager steps agree bit for bit. On the CPU Adam keeps
its host learning rate.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

def _exp_schedule(lr: float, gamma: Optional[float], steps_per_epoch: int
                  ) -> Callable[[int], float]:
    """LR of optimizer update ``count``: ``lr * gamma ** (count // spe)``
    (``lr`` when ``gamma`` is None)."""
    spe = max(1, steps_per_epoch)
    if gamma is None:
        return lambda count: lr
    if gamma == 0.0:
        return lambda count: lr * float(count < spe)
    return lambda count: lr * gamma ** (count // spe)


def _accum(exp_params: Dict[str, Any]) -> int:
    return int(exp_params.get("accumulate_grad_batches", 1) or 1)


class Optimizer:
    """Adam over one parameter group, with the clip, the schedule and the
    gradient accumulation around it. ``step()`` reads ``p.grad``."""

    def __init__(self, params: List[nn.Parameter], lr: float,
                 weight_decay: float, schedule: Callable[[int], float],
                 clip: Optional[float] = None, accumulate: int = 1):
        self.params = list(params)
        device = self.params[0].device
        # on the card: a device LR and capturable Adam (see the module doc)
        self.lr = (torch.tensor(float(lr), device=device)
                   if device.type == "cuda" else None)
        self.adam = torch.optim.Adam(
            self.params, lr=lr if self.lr is None else self.lr,
            weight_decay=weight_decay, capturable=self.lr is not None)
        self.schedule = schedule
        self.clip = clip
        self.accumulate = accumulate
        self.count = 0          # optimizer updates made so far
        self.mini_step = 0      # gradients accumulated toward the next one
        self.version = 0        # state loads so far (a graph holds the state)
        self._acc: Optional[List[torch.Tensor]] = None

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def set_lr(self) -> None:
        """The schedule's LR of update ``count`` into Adam's group: a Python
        float on the CPU, on the card filled into the device tensor that
        the group (and a graph captured from it) reads."""
        value = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = value if self.lr is None else self.lr
        if self.lr is not None:
            self.lr.fill_(value)

    def update(self) -> None:
        """The device work of one update: the clip, then Adam. Launches
        only, no host read of a device value, so it can be captured."""
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        self.adam.step()

    def step(self) -> bool:
        """Take the current gradients; returns whether the parameters were
        updated (always, unless accumulating)."""
        if self.accumulate > 1:
            grads = self._grads()
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self._acc = [a + (g - a) / (n + 1)
                         for a, g in zip(self._acc, grads)]
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            for p, a in zip(self.params, self._acc):
                p.grad = a
            self._acc, self.mini_step = None, 0
        self.set_lr()
        self.update()
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Adam's moments and step, the schedule position and the
        accumulation in progress."""
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self._acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load ``state_dict()``'s output, also one saved on another
        device, or with Adam in the other form (capturable or not):
        torch's load takes the saved groups' settings, so the form of this
        device is put back, with Adam's step counts where it keeps them
        (on the parameter's device when capturable, else on the host)."""
        self.adam.load_state_dict(state["adam"])
        capturable = self.lr is not None
        for group in self.adam.param_groups:
            group["capturable"] = capturable
            for p in group["params"]:
                st = self.adam.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(
                        p.device if capturable else "cpu", torch.float32)
        self.version += 1
        self.count, self.mini_step = state["count"], state["mini_step"]
        self._acc = (None if state["acc"] is None else
                     [a.to(p.device) for a, p in zip(state["acc"],
                                                     self.params)])


def _trained(model: nn.Module, prefix: Optional[str]) -> List[nn.Parameter]:
    """The parameters under the top-level submodules named ``prefix...``
    (all of them when ``prefix`` is None)."""
    return [p for name, p in model.named_parameters()
            if prefix is None or name.split(".")[0].startswith(prefix)]


def build_lr_schedules(exp_params: Dict[str, Any],
                       steps_per_epoch: int = 1) -> List[Callable]:
    """Global train step -> learning rate of each optimizer, mirroring
    ``build_optimizers`` (for logging)."""
    accum = _accum(exp_params)
    spe = max(1, steps_per_epoch // accum)
    lrs = [(exp_params.get("LR", 1e-3), exp_params.get("scheduler_gamma"))]
    if exp_params.get("LR_2") is not None:
        lrs.append((exp_params["LR_2"], exp_params.get("scheduler_gamma_2")))
    scheds = [_exp_schedule(lr, gamma, spe) for lr, gamma in lrs]
    return [lambda step, s=s: s(step // accum) for s in scheds]


def build_optimizers(exp_params: Dict[str, Any], model: nn.Module,
                     steps_per_epoch: int = 1) -> List[Optimizer]:
    """The ``Optimizer`` over the trained parameters of ``model``, and with
    ``LR_2`` a second one over the ``submodel`` parameters."""
    accum = _accum(exp_params)
    spe = max(1, steps_per_epoch // accum)
    clip = exp_params.get("gradient_clip_val")
    lr = exp_params.get("LR", 1e-3)
    params = _trained(model, exp_params.get("update_parameters"))
    if not params:
        raise ValueError(f"update_parameters="
                         f"{exp_params.get('update_parameters')!r} names no "
                         f"parameter of the model")
    optimizers = [Optimizer(
        params, lr, exp_params.get("weight_decay", 0.0) or 0.0,
        _exp_schedule(lr, exp_params.get("scheduler_gamma"), spe),
        clip=clip, accumulate=accum)]
    lr_2 = exp_params.get("LR_2")
    if lr_2 is not None:
        params = _trained(model, exp_params.get("submodel"))
        if not params:
            raise ValueError(f"submodel={exp_params.get('submodel')!r} "
                             f"names no parameter of the model")
        optimizers.append(Optimizer(
            params, lr_2, 0.0,
            _exp_schedule(lr_2, exp_params.get("scheduler_gamma_2"), spe),
            clip=clip, accumulate=accum))
    return optimizers
