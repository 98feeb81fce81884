"""JAX (flax) params -> the port's ``state_dict``.

The flax param pytree, as nested dicts of numpy arrays, maps one to one
onto the port's parameter names (the port's submodules carry flax's
names); only the kernel layouts change, and the layout of a leaf is
chosen by the type of the port's module it lands in, never by the flax
name (BetaTCVAE's ``dec_convs_0`` and LVAE's ``final_up`` are
ConvTranspose, LVAE's ``final_bn`` and ``dec_blocks_0_1`` BatchNorm):

* ``Conv2d`` kernels HWIO -> OIHW;
* ``ConvTranspose2d`` kernels (kh, kw, in, out) -> [in, out, kh, kw]
  with the spatial taps flipped back (a torch transposed conv correlates
  with the flipped kernel; k4-s2 'SAME' is torch ``padding=1``, k3-s2
  padded ((1, 2), (1, 2)) is ``padding=1, output_padding=1``);
* ``Linear`` (flax ``Dense``) kernels [in, out] -> weight [out, in];
* a ``BatchNorm``'s ``scale`` -> ``weight`` (its ``bias`` keeps its name);
* every other leaf (GAT ``lin_edge`` / ``att`` / ``bias``, the ``disc_*``
  discoverers, the mask MLP, the codebooks) is copied as it is.

An EMA codebook's ``vq_stats`` collection (``embedding``,
``cluster_size``, ``embed_avg`` of each quantizer) maps by the same
names onto the model's buffers, and BatchNorm's ``batch_stats`` (``mean``,
``var``) onto its ``running_mean`` / ``running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.backbones import BatchNorm


#: BatchNorm leaves: flax's name -> the port's
_BATCH_NORM = {"scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _convert_leaf(path: tuple, a: np.ndarray, modules: Dict[str, nn.Module]):
    """(port parameter name, array in the port's layout) of one leaf;
    ``modules`` is the model's ``named_modules()``."""
    *parents, leaf = path
    module = modules.get(".".join(parents))
    if isinstance(module, BatchNorm) and leaf in _BATCH_NORM:
        return ".".join(parents + [_BATCH_NORM[leaf]]), a
    if leaf != "kernel":
        return ".".join(path), a
    name = ".".join(parents + ["weight"])
    if isinstance(module, nn.ConvTranspose2d):
        return name, a[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return name, a.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        return name, a.T
    raise KeyError(f"JAX kernel {'/'.join(path)} lands in no Conv2d, "
                   f"ConvTranspose2d or Linear of the port ({name})")


def from_jax_params(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` filled from flax ``params`` (the
    ``params`` collection itself, or a variables dict holding it and, for
    an EMA codebook, its ``vq_stats``, for BatchNorm its ``batch_stats``).

    Raises if a leaf maps to no parameter or buffer of the model, if a
    shape disagrees, or if a parameter of the model is left unfilled (and,
    given a variables dict, a buffer of its state)."""
    leaves, targets = {}, dict(model.named_parameters())
    if "params" in params and isinstance(params["params"], Mapping):
        buffers = {k: v for k, v in model.state_dict().items()
                   if k not in targets}
        targets.update(buffers)
        for collection in ("vq_stats", "batch_stats"):
            leaves.update(_flatten(params.get(collection, {})))
        params = params["params"]
    leaves.update(_flatten(params))
    state: Dict[str, torch.Tensor] = {}
    modules = dict(model.named_modules())
    for path, a in leaves.items():
        name, arr = _convert_leaf(path, a, modules)
        if name not in targets:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart "
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
        raise KeyError(f"port params or buffers left unfilled: {missing}")
    return state
