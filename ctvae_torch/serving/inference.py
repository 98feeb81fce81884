"""Serving entry points of the port.

Counterpart of ``ctvae_tpu/serving/export.py::make_inference_fn`` for the
models of the port's registry: the same entry points and signatures minus
the JAX key. Each
callable takes an optional ``generator=`` (a ``torch.Generator`` on the
model's device) for its random draws and runs under
``torch.inference_mode()``. ``entry_fn`` is the same entry point with its
draws' source first: a generator, or the int64 key tensor of an exported
artifact (``serving/export.py``), which draws from ``KeyedDraws``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..models.base import Draws
from .draws import KeyedDraws

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


def _draws(model, source: Union[None, torch.Generator, torch.Tensor]):
    """The draws of one call, on the model's device: keyed by ``source``
    when it is an int64 key tensor, else from the generator (or the
    default one when None)."""
    if isinstance(source, torch.Tensor):
        return KeyedDraws(source, model.device)
    return Draws(source, model.device)


def encode_repr(model, x: torch.Tensor, draws: Optional[Draws] = None
                ) -> torch.Tensor:
    """The first output of ``model.encode(x)`` flattened per sample: the
    first array of a nested one (LVAE's rungs of (mu, log_var)); a model
    whose ``encode`` draws (``stochastic_encode``: HVAE's z2) gets
    ``draws``, as JAX's encode gets the stream keys."""
    if getattr(model, "stochastic_encode", False):
        z = model.encode(x, draws=draws)[0]
    else:
        z = model.encode(x)[0]
    while isinstance(z, (tuple, list)):
        z = z[0]
    return z.reshape(z.shape[0], -1)


def make_inference_fn(model, name: str, *, num_samples: int = 64
                      ) -> Callable:
    """The inference callable of entry point ``name`` (``entry_fn``'s
    arrays, with the draws from ``generator=``, under
    ``torch.inference_mode()``):

    * ``reconstruct(x)``: images [B, H, W, C] (a CT model's base-mode
      forward, through the identity transition);
    * ``encode(x)``: the encoder's first output, flattened per sample
      (``encode_repr``);
    * ``sample()``: ``num_samples`` images decoded from random latents;
    * for a model that ``needs_labels`` (ConditionalVAE), as the JAX
      package serves it: ``reconstruct(x, labels)``, ``encode(x,
      labels)`` (``encode_labeled``: the raw image with its labels) and
      ``sample(labels)`` (beside its first ``num_samples`` rows);
    * ``apply_action(x, input_y, action)``: action-mode forward, images;
    * ``classify_action(x, input_y)``: causal-mode softmin probabilities
      over the actions [B, A].
    """
    fn = entry_fn(model, name, num_samples=num_samples)

    def serve(*args, generator: Optional[torch.Generator] = None):
        with torch.inference_mode():
            return fn(generator, *args)
    serve.__name__ = name
    return serve


def entry_fn(model, name: str, *, num_samples: int = 64) -> Callable:
    """Entry point ``name`` as ``fn(source, *arrays)``: the arrays of
    ``make_inference_fn``'s callable, the draws from ``source`` (a
    generator, None, or an int64 key tensor: ``_draws``). Runs in the
    caller's grad mode."""
    if name not in available_fns(model):
        raise ValueError(f"unknown or unavailable inference fn {name!r}; "
                         f"choose from {available_fns(model)}")

    labelled = getattr(model, "needs_labels", False)
    if name == "reconstruct" and labelled:
        def fn(source, x, labels):
            return model(x, labels, draws=_draws(model, source))["recons"]
    elif name == "reconstruct":
        def fn(source, x):
            return model(x, mode="base",
                         draws=_draws(model, source))["recons"]
    elif name == "encode" and labelled:
        def fn(source, x, labels):
            z = model.encode_labeled(x, labels)[0]
            return z.reshape(z.shape[0], -1)
    elif name == "encode":
        def fn(source, x):
            return encode_repr(model, x, _draws(model, source))
    elif name == "sample" and labelled:
        def fn(source, labels):
            return model.sample(num_samples, labels,
                                draws=_draws(model, source))
    elif name == "sample":
        def fn(source):
            return model.sample(num_samples, draws=_draws(model, source))
    elif name == "apply_action":
        def fn(source, x, input_y, action):
            return model(x, input_y=input_y, action=action, mode="action",
                         draws=_draws(model, source))["recons"]
    else:
        def fn(source, x, input_y):
            # serving has no true action: the accuracy metrics get a dummy
            dummy = x.new_zeros((x.shape[0], model.action_dim))
            return model(x, input_y=input_y, action=dummy, mode="causal",
                         draws=_draws(model, source))["recons"]
    fn.__name__ = name
    return fn
