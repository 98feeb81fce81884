"""Exported serving artifacts: one ``torch.export`` program per entry point.

Counterpart of ``ctvae_tpu/serving/export.py``. A model's inference entry
points (``inference.py``) are traced once with its weights, which the
program carries, so a serving process needs no model code and no
checkpoint: ``load_artifact`` imports torch and the kernels' custom ops
(``ops/library.py``) only. The kernels stay in the program as
``ctvae::`` ops, so the program launches the hand-written kernels on the
card and runs their plain versions on the CPU: one file exported on the
card serves there and in a CPU canary (``load_artifact(device="cpu")``).

Every exported function takes one int64 ``key`` tensor (0-d) first, as
JAX's take one PRNG key; its random draws come from
``draws.KeyedDraws(key)``, and the deterministic paths ignore the key. The
batch dimension can be exported symbolically (``poly_batch``): one shared
dimension ``b`` for the leading dimension of every array after the key,
so one artifact serves any batch size, 1 included (an example batch of 1
is traced at 2: ``export_fn``).

A model at ``dtype: bfloat16`` exports as one at float32: its
parameters' casts to the compute dtype (``ops/layers.py``) are nodes of
the program, the kernels' ops take their bfloat16 instantiations, and
the program takes and returns what the JAX package's entry function
takes and returns at that dtype (float32 images; ``encode``'s bfloat16
latents). ``model_manifest`` records the compute dtype.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import ops  # noqa: F401  (registers the kernels' custom ops)

MANIFEST_NAME = "manifest.json"


class EntryPoint(nn.Module):
    """Entry point ``name`` of ``model`` as a module: ``forward(key,
    *arrays)``, the arrays of ``inference.make_inference_fn``'s callable
    after an int64 key tensor that keys the draws. Called eagerly (under
    ``torch.inference_mode()``), it is the live port on that key. The
    entry points and which a model serves are ``inference.py``'s
    (``INFERENCE_FNS``, ``available_fns``)."""

    def __init__(self, model: nn.Module, name: str, *,
                 num_samples: int = 64):
        super().__init__()
        from .inference import entry_fn
        self.model = model
        self._fn = entry_fn(model, name, num_samples=num_samples)

    def forward(self, key: torch.Tensor, *arrays: torch.Tensor
                ) -> torch.Tensor:
        return self._fn(key, *arrays)


def export_fn(fn: nn.Module, example_args: Sequence[torch.Tensor], *,
              poly_batch: bool = False,
              mesh=None) -> torch.export.ExportedProgram:
    """Trace ``fn`` (an ``EntryPoint``) at ``example_args`` (the key, then
    the arrays) with ``torch.export``, without autograd. With
    ``poly_batch`` the leading dimension of every array after the key is
    one symbolic dimension ``b`` (at least 1). ``torch.export`` takes a
    dimension of size 1 for a constant, so an example batch of 1 is traced
    with its rows repeated to 2; the program serves a batch of 1 all the
    same. A ``mesh`` (the JAX package's SPMD export, the batch split over
    its data axis) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError("the SPMD export over a mesh is not "
                                  "ported yet (ROADMAP A8.3)")
    args = tuple(example_args)
    dynamic = None
    if poly_batch:
        if any(a.shape[0] == 1 for a in args[1:]):
            args = args[:1] + tuple(torch.cat([a, a]) for a in args[1:])
        b = torch.export.Dim("b", min=1)
        dynamic = (None, tuple({0: b} for _ in args[1:]))
    with torch.no_grad():
        return torch.export.export(fn, args, dynamic_shapes=dynamic)


def model_manifest(model: nn.Module) -> dict:
    """The manifest's entries of ``model``: its class name and its
    compute dtype (``float32`` or ``bfloat16``)."""
    dtype = getattr(model, "compute_dtype", torch.float32)
    return {"model": type(model).__name__,
            "dtype": str(dtype).replace("torch.", "")}


def _specs(values, batch) -> list:
    """``dtype[d0, d1, ...]`` of each value, the symbolic batch as ``b``."""
    out = []
    for v in values:
        dims = ["b" if batch is not None and str(d) == batch else str(d)
                for d in v.shape]
        out.append(f"{str(v.dtype).replace('torch.', '')}[{', '.join(dims)}]")
    return out


def _signature(exported: torch.export.ExportedProgram) -> dict:
    """The input and output specs and the device of an exported program."""
    inputs = {s.arg.name for s in exported.graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT}
    placeholders = [n.meta["val"] for n in exported.graph.nodes
                    if n.op == "placeholder" and n.name in inputs]
    (output,) = [n for n in exported.graph.nodes if n.op == "output"]
    results = [a.meta["val"] for a in torch.utils._pytree.tree_leaves(
        output.args) if isinstance(a, torch.fx.Node)]
    batch = None
    if len(placeholders) > 1 and placeholders[1].dim() > 0:
        d = placeholders[1].shape[0]
        batch = str(d) if isinstance(d, torch.SymInt) else None
    return {"in_specs": _specs(placeholders, batch),
            "out_specs": _specs(results, batch),
            "device": str(placeholders[0].device)}


def save_artifact(out_dir: str,
                  exported: Dict[str, torch.export.ExportedProgram],
                  extra_manifest: Optional[dict] = None) -> str:
    """Write one ``<name>.pt2`` per entry point (``torch.export.save``)
    plus ``manifest.json``: the torch version, ``extra_manifest``'s
    entries (``model_manifest``'s: the model and its compute dtype) and,
    per function, its file, its input / output specs (the symbolic batch
    as ``b``) and the device it was exported on."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"torch_version": torch.__version__, "functions": {}}
    manifest.update(extra_manifest or {})
    for name, exp in exported.items():
        torch.export.save(exp, os.path.join(out_dir, f"{name}.pt2"))
        manifest["functions"][name] = {"file": f"{name}.pt2",
                                       **_signature(exp)}
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return out_dir


def _serving(module: nn.Module) -> Callable:
    def serve(*args):
        with torch.inference_mode():
            return module(*args)
    return serve


def load_artifact(art_dir: str, device=None
                  ) -> Tuple[Dict[str, Callable], dict]:
    """Load a saved artifact: name -> callable ``(key, *arrays)`` (under
    ``torch.inference_mode()``) plus the manifest. With ``device`` each
    program is moved there first (``move_to_device_pass``), so a program
    exported on the card serves on the CPU too. Imports no model code."""
    (fns,), manifest = load_artifact_on(art_dir, [device])
    return fns, manifest


def load_artifact_on(art_dir: str, devices: Sequence
                     ) -> Tuple[List[Dict[str, Callable]], dict]:
    """``load_artifact`` on each of ``devices`` (None: where it was
    exported) from one read of each file: per device, name -> callable,
    and the manifest."""
    with open(os.path.join(art_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    fns: List[Dict[str, Callable]] = [{} for _ in devices]
    for name, meta in manifest["functions"].items():
        exp = torch.export.load(os.path.join(art_dir, meta["file"]))
        for i, device in enumerate(devices):
            moved = exp
            if device is not None:
                from torch.export.passes import move_to_device_pass
                moved = move_to_device_pass(copy.deepcopy(exp),
                                            str(torch.device(device)))
            fns[i][name] = _serving(moved.module())
    return fns, manifest
