"""Checkpoints of the port: the best ``top_k`` by a monitored metric plus
``last``, full-state restore, and the weights-only restore of the
two-stage CT recipe.

Counterpart of ``ctvae_tpu/utils/checkpoint.py`` (orbax there, one
``torch.save`` file per checkpoint here). A checkpoint is a
``TrainState.state_dict()``: the model's ``state_dict``, each optimizer's
state (Adam moments and step, the LR-schedule position), the global step
and the train generator's state. ``index.json`` keeps the top-k list.

``save`` first copies the state to host memory, then writes it: inline,
or with ``async_save`` (``exp_params.async_checkpointing``) on a
non-daemon thread, so the write overlaps the next epoch. Writes are
serialised; ``wait()`` joins the one in flight and raises its error;
``path`` and ``restore`` wait first. Both modes write the same files, byte
for byte. Under a process group only rank 0 writes (the ranks hold the
same state); every rank restores. Under FSDP the state is the full one,
which every rank gathers (``TrainState.state_dict`` is a collective
there) before rank 0 writes it, so the files are those of one process.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn


def _load(path: str) -> Dict[str, Any]:
    # tensors, numbers, strings and containers only: no code is unpickled
    return torch.load(path, map_location="cpu", weights_only=True)


def _host_copy(obj):
    """``obj`` with every tensor copied to host memory (the state a write
    serialises while the card trains on)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


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
                 monitor: str = "val_Reconstruction_Loss",
                 async_save: bool = False):
        self.dir = os.path.abspath(ckpt_dir)
        self.top_k = top_k
        self.monitor = monitor
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        from ..parallel.mesh import is_primary
        self.writes = is_primary()
        if self.writes:
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

    def wait(self) -> None:
        """Join the write in flight, if any, and raise its error (a failed
        save must not pass for a saved one)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, state, step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Save ``state`` (a ``TrainState``) as ``last`` and, when
        ``metrics`` holds the monitored value, as ``step_<step>`` if it is
        among the best ``top_k``. The state is copied to the host before
        this returns; the write follows inline or, with ``async_save``, on
        a thread of its own after the previous one. Only rank 0 of a
        process group writes; under FSDP every rank takes part in
        gathering the state, on this thread."""
        sharded = getattr(state, "fsdp", None) is not None
        if not self.writes and not sharded:
            return
        blob = state.state_dict()
        if not self.writes:
            return
        blob = _host_copy(blob)
        score = None if metrics is None else metrics.get(self.monitor)
        self.wait()
        if not self.async_save:
            self._write(blob, step, score)
            return

        def write():
            try:
                self._write(blob, step, score)
            except Exception as e:            # raised by the next wait()
                self._error = e

        # not a daemon: the interpreter joins it at exit, so a crash
        # elsewhere cannot cut a write off halfway
        self._pending = threading.Thread(target=write, daemon=False)
        self._pending.start()

    def _write(self, blob, step: int, score: Optional[float]) -> None:
        """The state is serialised once: ``last`` is then a hard link to
        (or, where links fail, a copy of) ``step_<step>``."""
        last = os.path.join(self.dir, "last")
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
        """The file of ``which``: 'last', 'best', or a path (after the
        write in flight; a rank other than 0 rereads the index that rank 0
        writes)."""
        self.wait()
        if not self.writes:
            self._index = self._load_index()
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
    """Copy into ``model`` the parameters of the checkpoint at ``path``
    that it has under the same name and shape; every other parameter keeps
    its value (non-strict, the reference's ``strict=False`` load). Buffers
    are not loaded: an EMA codebook's stay as initialised, as the JAX
    package restores ``params`` alone. Returns the names loaded. The
    optimizers are not touched."""
    blob = _load(path)
    src = blob.get("model", blob)
    loaded = []
    with torch.no_grad():
        for name, dst in model.named_parameters():
            t = src.get(name)
            if t is not None and tuple(t.shape) == tuple(dst.shape):
                dst.copy_(t)
                loaded.append(name)
    return loaded
