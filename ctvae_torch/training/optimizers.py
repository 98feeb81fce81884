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

Adversarial models (``LR_2`` / ``submodel``) are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

NOT_PORTED = ("LR_2 / submodel (a second optimizer for adversarial models) "
              "is not ported yet: ROADMAP A6")


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
        self.adam = torch.optim.Adam(self.params, lr=lr,
                                     weight_decay=weight_decay)
        self.schedule = schedule
        self.clip = clip
        self.accumulate = accumulate
        self.count = 0          # optimizer updates made so far
        self.mini_step = 0      # gradients accumulated toward the next one
        self._acc: Optional[List[torch.Tensor]] = None

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

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
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Adam's moments and step, the schedule position and the
        accumulation in progress."""
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self._acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
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
    """Global train step -> learning rate, mirroring ``build_optimizers``
    (for logging)."""
    if exp_params.get("LR_2") is not None:
        raise NotImplementedError(NOT_PORTED)
    accum = _accum(exp_params)
    sched = _exp_schedule(exp_params.get("LR", 1e-3),
                          exp_params.get("scheduler_gamma"),
                          max(1, steps_per_epoch // accum))
    return [lambda step: sched(step // accum)]


def build_optimizers(exp_params: Dict[str, Any], model: nn.Module,
                     steps_per_epoch: int = 1) -> List[Optimizer]:
    """A list of one ``Optimizer`` over the trained parameters of
    ``model``."""
    if exp_params.get("LR_2") is not None or exp_params.get("submodel"):
        raise NotImplementedError(NOT_PORTED)
    lr = exp_params.get("LR", 1e-3)
    accum = _accum(exp_params)
    schedule = _exp_schedule(lr, exp_params.get("scheduler_gamma"),
                             max(1, steps_per_epoch // accum))
    params = _trained(model, exp_params.get("update_parameters"))
    if not params:
        raise ValueError(f"update_parameters="
                         f"{exp_params.get('update_parameters')!r} names no "
                         f"parameter of the model")
    return [Optimizer(params, lr, exp_params.get("weight_decay", 0.0) or 0.0,
                      schedule, clip=exp_params.get("gradient_clip_val"),
                      accumulate=accum)]
