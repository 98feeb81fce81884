"""Experiment logging: scalars to ``scalars.jsonl``, images to PNG files.

Counterpart of ``ctvae_tpu/utils/logging.py`` with its writer for hosts
that have no TensorBoard (the card's machine has none): each run gets
``<save_dir>/<name>/version_<n>`` (n one above the highest there),
``hparams.json`` holds the config, and ``log_all`` routes a mixed dict as
the JAX logger does: 0-d values are scalars (one JSON line
``{"step": s, "<name>": v}`` each), 2-D and 3-D arrays (``ct_adjacency``)
images (``<name>_<step>.png``, min-max scaled, grey made RGB), the rest
(strings, 1-D arrays) is dropped. ``use_wandb`` logs to wandb as well where the
package is installed and initialises; otherwise it is off.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .images import png_bytes, to_uint8


def next_version_dir(save_dir: str, name: str) -> str:
    """``<save_dir>/<name>/version_<n>``, n one above the highest existing
    version (0 for the first run)."""
    base = os.path.join(save_dir, name)
    versions = [int(d.split("_")[1]) for d in
                (os.listdir(base) if os.path.isdir(base) else [])
                if d.startswith("version_") and d.split("_")[1].isdigit()]
    return os.path.join(base,
                        f"version_{max(versions) + 1 if versions else 0}")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


class ExperimentLogger:

    def __init__(self, save_dir: str, name: str, version: Optional[int] = None,
                 use_wandb: bool = False, wandb_project: str = "CT-VAE",
                 hparams: Optional[dict] = None):
        self.log_dir = (
            next_version_dir(save_dir, name) if version is None
            else os.path.join(save_dir, name, f"version_{version}"))
        self.version = int(self.log_dir.rsplit("_", 1)[1])
        os.makedirs(self.log_dir, exist_ok=True)
        self._scalars = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb.init(project=wandb_project, name=name,
                                        config=hparams or {},
                                        dir=self.log_dir)
            except Exception:      # no wandb, or it cannot start: off
                self.wandb = None
        if hparams is not None:
            with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
                json.dump(_jsonable(hparams), f, indent=2, default=str)

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self._scalars.write(json.dumps(
            {"step": int(step), name: float(value)}) + "\n")

    def log_all(self, values: Dict[str, Any], step: int,
                prefix: str = "") -> Dict[str, float]:
        """Route a mixed dict of scalars and images; returns the scalars."""
        scalars: Dict[str, float] = {}
        for key, val in values.items():
            if isinstance(val, str):
                continue
            arr = np.asarray(val)
            name = prefix + key
            if arr.ndim == 0:
                scalars[name] = float(arr)
                self.add_scalar(name, float(arr), step)
            elif arr.ndim in (2, 3):
                self.log_image(name, arr, step)
        if self.wandb is not None and scalars:
            self.wandb.log(scalars, step=step)
        return scalars

    def log_image(self, name: str, img: np.ndarray, step: int) -> None:
        """One [H, W] or [H, W, C] array as ``<name>_<step>.png``."""
        img = np.asarray(img, np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        safe = name.replace("/", "_")
        with open(os.path.join(self.log_dir, f"{safe}_{step}.png"), "wb") as f:
            f.write(png_bytes(to_uint8(img)))
        if self.wandb is not None:
            import wandb
            self.wandb.log({name: wandb.Image(img)}, step=step)

    def finish(self) -> None:
        self._scalars.close()
        if self.wandb is not None:
            self.wandb.finish()
