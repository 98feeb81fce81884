"""Serving entry points of the port.

Counterpart of ``ctvae_tpu/serving/export.py::make_inference_fn`` for the
CT-MCQ-VAE and the MCQVAE: the same entry points and signatures minus the
JAX key. Each
callable takes an optional ``generator=`` (a ``torch.Generator`` on the
model's device) for its random draws and runs under
``torch.inference_mode()``. Exported artifacts are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models.base import Draws

#: serving entry points of the JAX package; ``available_fns`` says which
#: the port serves for a model
INFERENCE_FNS = ("reconstruct", "encode", "sample", "apply_action",
                 "classify_action")


def _is_ct(model) -> bool:
    return hasattr(model, "forward_causal")


def available_fns(model) -> Tuple[str, ...]:
    """Entry points the port serves for ``model``, as the JAX package
    serves them: ``sample`` for a model with a usable prior, the action
    entry points for a CT model."""
    fns = ["reconstruct", "encode"]
    if hasattr(model, "sample"):
        fns.append("sample")
    if _is_ct(model):
        fns += ["apply_action", "classify_action"]
    return tuple(fns)


def _draws(model, generator: Optional[torch.Generator]) -> Draws:
    return Draws(generator, model.device)


def make_inference_fn(model, name: str, *, num_samples: int = 64
                      ) -> Callable:
    """The inference callable of entry point ``name``:

    * ``reconstruct(x)``: images [B, H, W, C] (a CT model's base-mode
      forward, through the identity transition);
    * ``encode(x)``: the encoder latents, flattened per sample;
    * ``sample()``: ``num_samples`` images decoded from random latents;
    * ``apply_action(x, input_y, action)``: action-mode forward, images;
    * ``classify_action(x, input_y)``: causal-mode softmin probabilities
      over the actions [B, A].
    """
    if name not in available_fns(model):
        raise ValueError(f"unknown or unavailable inference fn {name!r}; "
                         f"choose from {available_fns(model)}")

    if name == "reconstruct":
        def fn(x, *, generator=None):
            return model(x, mode="base",
                         draws=_draws(model, generator))["recons"]
    elif name == "encode":
        def fn(x, *, generator=None):
            z = model.encode(x)[0]
            return z.reshape(z.shape[0], -1)
    elif name == "sample":
        def fn(*, generator=None):
            return model.sample(num_samples, draws=_draws(model, generator))
    elif name == "apply_action":
        def fn(x, input_y, action, *, generator=None):
            return model(x, input_y=input_y, action=action, mode="action",
                         draws=_draws(model, generator))["recons"]
    else:
        def fn(x, input_y, *, generator=None):
            # serving has no true action: the accuracy metrics get a dummy
            dummy = x.new_zeros((x.shape[0], model.action_dim))
            return model(x, input_y=input_y, action=dummy, mode="causal",
                         draws=_draws(model, generator))["recons"]

    def serve(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    serve.__name__ = name
    serve.__doc__ = fn.__doc__
    return serve
