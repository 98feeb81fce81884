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
  updates, not calls. The mean is kept in fixed buffers, updated in place
  (``a += (g - a) / (n + 1)`` at mini-step n) and zeroed after each
  update.
* ``LR_2`` (adversarial models, FactorVAE): a second Adam(LR_2) with
  weight decay 0 and the same clip over the parameters under the
  top-level submodules named ``submodel...`` (all of them without
  ``submodel``), on its own staircase ``scheduler_gamma_2``; the first
  optimizer keeps every parameter it had (the discriminator too: JAX's
  first transform is unmasked). The train step of ``optimizer_idx`` k
  steps optimizer k alone.

Under FSDP (``parallel/fsdp.py``, ``build_optimizers(fsdp=...)``) an
optimizer takes each split parameter's slice in its place, so Adam's
moments cover the slice alone, and its clip reads the global norm of its
parameters' gradients (the slices' squares summed over the data group).

On a CUDA device the update can be captured into a CUDA graph
(``training/state.py::make_multi_train_step``): the learning rate is a
device tensor, filled from the schedule before each update outside any
graph, and Adam runs with ``capturable=True`` (its step count on the
device too). So is the accumulation's divisor n + 1, filled before each
mini-step, so that one graph serves every mini-step but the last. The
eager update on the card runs the same arithmetic, so a replayed graph
and eager steps agree bit for bit. On the CPU Adam keeps its host
learning rate and the mean divides by the host's n + 1.
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
                 clip: Optional[float] = None, accumulate: int = 1,
                 grad_norm: Optional[Callable[[], torch.Tensor]] = None):
        self.params = list(params)
        # the clip's norm where it is not that of the local gradients
        # (FSDP's slices: ``FSDP.norm_fn``)
        self.grad_norm = grad_norm
        device = self.params[0].device
        # on the card: a device LR and capturable Adam (see the module doc)
        on_card = device.type == "cuda"
        self.lr = torch.tensor(float(lr), device=device) if on_card else None
        self.adam = torch.optim.Adam(
            self.params, lr=lr if self.lr is None else self.lr,
            weight_decay=weight_decay, capturable=self.lr is not None)
        self.schedule = schedule
        self.clip = clip
        self.accumulate = accumulate
        self.count = 0          # optimizer updates made so far
        self.mini_step = 0      # gradients accumulated toward the next one
        self.version = 0        # state loads so far (a graph holds the state)
        # the running mean of the gradients (zeros between updates) and,
        # on the card, the divisor of the next mini-step
        self._acc: Optional[List[torch.Tensor]] = None
        self._div = (torch.ones((), device=device)
                     if on_card and accumulate > 1 else None)

    def started(self) -> bool:
        """Whether Adam holds its moments (created by the first update)."""
        return bool(self.adam.state)

    def acc_buffers(self) -> List[torch.Tensor]:
        """The accumulation's buffers, made (zero) at first use."""
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in self.params]
        return self._acc

    def set_div(self) -> None:
        """On the card, the divisor of mini-step ``mini_step`` into the
        device scalar that ``accumulate_grads`` (and a graph captured from
        it) reads."""
        if self._div is not None:
            self._div.fill_(self.mini_step + 1)

    def accumulate_grads(self) -> None:
        """The device work of a mini-step: the current gradients (zero
        where a parameter has none) into the running mean, in place."""
        div = self.mini_step + 1 if self._div is None else self._div
        for a, p in zip(self.acc_buffers(), self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / div)

    def take_mean(self) -> None:
        """The device work after the last mini-step: the mean into
        ``p.grad`` and the buffers zeroed for the next update."""
        for p, a in zip(self.params, self._acc):
            if p.grad is None:
                p.grad = a.clone()
            else:
                p.grad.copy_(a)
        torch._foreach_zero_(self._acc)

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
        if self.clip and self.grad_norm is None:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        elif self.clip:
            # clip_grad_norm_'s arithmetic on the global norm
            coef = torch.clamp(self.clip / (self.grad_norm() + 1e-6),
                               max=1.0)
            torch._foreach_mul_([p.grad for p in self.params
                                 if p.grad is not None], coef)
        self.adam.step()

    def step(self) -> bool:
        """Take the current gradients; returns whether the parameters were
        updated (always, unless accumulating)."""
        if self.accumulate > 1:
            self.set_div()
            self.accumulate_grads()
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            self.take_mean()
            self.mini_step = 0
        self.set_lr()
        self.update()
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Adam's moments and step, the schedule position and the
        accumulation in progress (a copy of the running mean, None
        between updates)."""
        acc = (None if self.mini_step == 0 or self._acc is None
               else [a.clone() for a in self._acc])
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load ``state_dict()``'s output, also one saved on another
        device, or with Adam in the other form (capturable or not):
        torch's load takes the saved groups' settings, so the form of this
        device is put back, with Adam's step counts where it keeps them
        (on the parameter's device when capturable, else on the host).
        The running mean is copied into this optimizer's buffers."""
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
        if state["acc"] is not None:
            for a, saved in zip(self.acc_buffers(), state["acc"]):
                a.copy_(saved)
        elif self._acc is not None:
            torch._foreach_zero_(self._acc)


def _trained(model: nn.Module, prefix: Optional[str], fsdp=None
             ) -> List[nn.Parameter]:
    """The parameters under the top-level submodules named ``prefix...``
    (all of them when ``prefix`` is None), each split one's slice in its
    place under ``fsdp``."""
    return [p if fsdp is None else fsdp.shard_of(p)
            for name, p in model.named_parameters()
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
                     steps_per_epoch: int = 1, fsdp=None) -> List[Optimizer]:
    """The ``Optimizer`` over the trained parameters of ``model``, and with
    ``LR_2`` a second one over the ``submodel`` parameters; under ``fsdp``
    (``parallel/fsdp.py::FSDP``) over the split parameters' slices."""
    accum = _accum(exp_params)
    spe = max(1, steps_per_epoch // accum)
    clip = exp_params.get("gradient_clip_val")
    lr = exp_params.get("LR", 1e-3)

    def norm(params):
        return None if fsdp is None else fsdp.norm_fn(params)
    params = _trained(model, exp_params.get("update_parameters"), fsdp)
    if not params:
        raise ValueError(f"update_parameters="
                         f"{exp_params.get('update_parameters')!r} names no "
                         f"parameter of the model")
    optimizers = [Optimizer(
        params, lr, exp_params.get("weight_decay", 0.0) or 0.0,
        _exp_schedule(lr, exp_params.get("scheduler_gamma"), spe),
        clip=clip, accumulate=accum, grad_norm=norm(params))]
    lr_2 = exp_params.get("LR_2")
    if lr_2 is not None:
        params = _trained(model, exp_params.get("submodel"), fsdp)
        if not params:
            raise ValueError(f"submodel={exp_params.get('submodel')!r} "
                             f"names no parameter of the model")
        optimizers.append(Optimizer(
            params, lr_2, 0.0,
            _exp_schedule(lr_2, exp_params.get("scheduler_gamma_2"), spe),
            clip=clip, accumulate=accum, grad_norm=norm(params)))
    return optimizers
