"""JAX (flax) params -> the port's ``state_dict``.

The flax param pytree, as nested dicts of numpy arrays, maps one to one
onto the port's parameter names (the port's submodules carry flax's
names); only the kernel layouts change:

* ``Conv`` kernels HWIO -> ``Conv2d`` OIHW;
* ``ConvTranspose`` kernels (kh, kw, in, out) -> ``ConvTranspose2d``
  [in, out, kh, kw] with the spatial taps flipped back (a torch
  transposed conv correlates with the flipped kernel; k4-s2 'SAME' is
  torch ``padding=1``);
* ``Dense`` kernels [in, out] -> ``Linear`` weight [out, in];
* every other leaf (GAT ``lin_edge`` / ``att`` / ``bias``, the ``disc_*``
  discoverers, the mask MLP, the codebooks) is copied as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _convert_leaf(path: tuple, a: np.ndarray):
    """(port parameter name, array in the port's layout) of one leaf."""
    *parents, leaf = path
    if leaf != "kernel":
        return ".".join(path), a
    name = ".".join(parents + ["weight"])
    if parents and parents[-1].startswith("ConvTranspose"):
        return name, a[::-1, ::-1].transpose(2, 3, 0, 1)
    if a.ndim == 4:
        return name, a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return name, a.T
    raise ValueError(f"unexpected kernel rank {a.ndim} at {'/'.join(path)}")


def from_jax_params(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` filled from flax ``params`` (the
    ``params`` collection itself, or a variables dict holding it).

    Raises if a leaf maps to no parameter of the model, if a shape
    disagrees, or if a parameter of the model is left unfilled."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    targets = dict(model.named_parameters())
    state: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(params).items():
        name, arr = _convert_leaf(path, a)
        if name not in targets:
            raise KeyError(f"JAX param {'/'.join(path)} has no counterpart "
                           f"({name})")
        t = targets[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} converts to "
                             f"{tuple(arr.shape)}, port has "
                             f"{tuple(t.shape)}")
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=t.dtype,
                                   device=t.device)
    missing = sorted(set(targets) - set(state))
    if missing:
        raise KeyError(f"port params left unfilled: {missing}")
    return state
