"""Checkpoints of the port: the best ``top_k`` by a monitored metric plus
``last``, full-state restore, and the weights-only restore of the
two-stage CT recipe.

Counterpart of ``ctvae_tpu/utils/checkpoint.py`` (orbax there, one
``torch.save`` file per checkpoint here). A checkpoint is a
``TrainState.state_dict()``: the model's ``state_dict``, each optimizer's
state (Adam moments and step, the LR-schedule position), the global step
and the train generator's state. ``index.json`` keeps the top-k list.
Asynchronous saves (``exp_params.async_checkpointing``) are not ported.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn


def _load(path: str) -> Dict[str, Any]:
    # tensors, numbers, strings and containers only: no code is unpickled
    return torch.load(path, map_location="cpu", weights_only=True)


def _link(src: str, dst: str) -> None:
    """``dst`` names the file at ``src``: a hard link, else a copy."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


class CheckpointManager:
    """Saves train states under ``ckpt_dir``; keeps the best ``top_k`` by
    a monitored scalar (lower is better) plus ``last``."""

    def __init__(self, ckpt_dir: str, top_k: int = 2,
                 monitor: str = "val_Reconstruction_Loss"):
        self.dir = os.path.abspath(ckpt_dir)
        self.top_k = top_k
        self.monitor = monitor
        os.makedirs(self.dir, exist_ok=True)
        self._index_path = os.path.join(self.dir, "index.json")
        self._index = self._load_index()

    def _load_index(self) -> Dict[str, Any]:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {"best": []}  # list of {"step", "score", "path"}

    def _write_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=2)

    @staticmethod
    def _publish(path: str, write: Callable[[str], None]) -> None:
        """Write crash-safely: ``write`` fills ``path.tmp``, which is then
        swapped in by rename. A kill at any instant leaves the complete old
        file or the complete new one at ``path`` (or, between the two
        renames, the old one at ``path.old``, which ``restore`` falls back
        to)."""
        tmp, old = path + ".tmp", path + ".old"
        for stale in (tmp, old):
            if os.path.exists(stale):
                os.remove(stale)
        write(tmp)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        if os.path.exists(old):
            os.remove(old)

    def save(self, state, step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Save ``state`` (a ``TrainState``) as ``last`` and, when
        ``metrics`` holds the monitored value, as ``step_<step>`` if it is
        among the best ``top_k``. The state is serialised once: ``last``
        is then a hard link to (or, where links fail, a copy of)
        ``step_<step>``."""
        blob = state.state_dict()
        last = os.path.join(self.dir, "last")
        score = None if metrics is None else metrics.get(self.monitor)
        if score is None:
            self._publish(last, lambda tmp: torch.save(blob, tmp))
            self._write_index()
            return
        path = os.path.join(self.dir, f"step_{step}")
        self._publish(path, lambda tmp: torch.save(blob, tmp))
        self._publish(last, lambda tmp: _link(path, tmp))
        best = self._index["best"]
        best.append({"step": step, "score": float(score), "path": path})
        best.sort(key=lambda e: e["score"])
        for evicted in best[self.top_k:]:
            if os.path.exists(evicted["path"]):
                os.remove(evicted["path"])
        self._index["best"] = best[:self.top_k]
        self._write_index()

    def path(self, which: str = "last") -> str:
        """The file of ``which``: 'last', 'best', or a path."""
        path = {"last": os.path.join(self.dir, "last"),
                "best": self._index["best"][0]["path"]
                if self._index["best"] else None}.get(which, which)
        if path is not None and not os.path.exists(path) \
                and os.path.exists(path + ".old"):
            # a kill landed between _publish's two renames: the
            # previous complete checkpoint is parked at .old
            path = path + ".old"
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path!r}")
        return path

    def restore(self, which: str = "last") -> Dict[str, Any]:
        """The saved state dict of ``which`` ('last', 'best', or a path),
        on the CPU; ``TrainState.load_state_dict`` puts it in place."""
        return _load(self.path(which))


def load_weights_only(path: str, model: nn.Module) -> List[str]:
    """Copy into ``model`` the entries of the checkpoint at ``path`` that
    it has under the same name and shape; every other entry keeps its
    value (non-strict, the reference's ``strict=False`` load). Returns the
    names loaded. The optimizers are not touched."""
    blob = _load(path)
    src = blob.get("model", blob)
    loaded = []
    with torch.no_grad():
        for name, dst in model.state_dict().items():
            t = src.get(name)
            if t is not None and tuple(t.shape) == tuple(dst.shape):
                dst.copy_(t)
                loaded.append(name)
    return loaded
