"""Train state and the per-mode train / eval steps.

Counterpart of ``ctvae_tpu/training/state.py`` (``make_train_step`` /
``make_eval_step``). PyTorch runs eagerly, so a step is a plain function:
forward under ``train``, ``loss_function``, ``backward``, the global
gradient norm over every parameter, then the optimizer. The random draws
of a step come from the state's ``generator`` (advanced by every train
step); the eval step draws from a generator of its own, seeded apart from
the train draws as the JAX package offsets its eval key by ``1 << 20``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch
from torch import nn

from ..models.base import Draws

#: batch keys a forward takes besides the image
FWD_KEYS = ("action", "input_y")

EVAL_SEED_OFFSET = 1 << 20


@dataclass
class TrainState:
    """All training state: the global ``step``, the ``model`` (whose
    parameters are the trained state), its ``optimizers`` and the
    ``generator`` of the train steps' random draws."""

    step: int
    model: nn.Module
    optimizers: List[Any]
    generator: torch.Generator

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit for bit: the
        parameters, each optimizer's state, the step and the generator."""
        return {"model": self.model.state_dict(),
                "optimizers": [o.state_dict() for o in self.optimizers],
                "step": self.step, "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        if len(state["optimizers"]) != len(self.optimizers):
            raise ValueError(f"checkpoint has {len(state['optimizers'])} "
                             f"optimizers, the state {len(self.optimizers)}")
        for opt, saved in zip(self.optimizers, state["optimizers"]):
            opt.load_state_dict(saved)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])


def create_train_state(model: nn.Module, optimizers: List[Any],
                       seed: int = 0) -> TrainState:
    gen = torch.Generator(model.device).manual_seed(seed)
    return TrainState(step=0, model=model, optimizers=list(optimizers),
                      generator=gen)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor], mode: str,
             draws: Draws, train: bool) -> Dict[str, Any]:
    kwargs = {k: batch[k] for k in FWD_KEYS if k in batch}
    outputs = model(batch["image"], mode=mode, draws=draws, train=train,
                    **kwargs)
    return model.loss_function(outputs)


def _scalars(losses: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Numeric entries, detached (strings such as ``mode`` dropped)."""
    return {k: v.detach() for k, v in losses.items()
            if isinstance(v, torch.Tensor)}


def make_train_step(mode: str) -> Callable[[TrainState, Dict], Dict]:
    """The train step of batch mode ``mode``: ``step(state, batch)``
    updates ``state`` in place (parameters, optimizer state, ``step``) and
    returns the loss terms, the model's metrics and ``grad_norm``."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.zero_grad(set_to_none=True)
        losses = _forward(model, batch, mode,
                          Draws(state.generator, model.device), train=True)
        losses["loss"].backward()
        metrics = _scalars(losses)
        # over every parameter, trained or not (optax.global_norm of the
        # whole gradient tree); an unused parameter's gradient is zero
        metrics["grad_norm"] = global_norm(
            p.grad for p in model.parameters() if p.grad is not None)
        for opt in state.optimizers:
            opt.step()
        state.step += 1
        return metrics

    return step_fn


def make_eval_step(mode: str, seed: int = 0
                   ) -> Callable[[TrainState, Dict], Dict]:
    """The validation step of batch mode ``mode``: forward with
    ``train=False`` and the loss, no gradient; its draws come from a
    generator of its own, seeded ``seed + (1 << 20)``."""
    generator = None

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        nonlocal generator
        device = state.model.device
        if generator is None:
            generator = torch.Generator(device).manual_seed(
                seed + EVAL_SEED_OFFSET)
        return _scalars(_forward(state.model, batch, mode,
                                 Draws(generator, device), train=False))

    return step_fn
