"""Host batches onto the device: pinned memory, non-blocking copies.

Counterpart of ``ctvae_tpu/data/prefetch.py``. ``to_device`` moves one
numpy batch: on a CUDA device each array is copied into pinned host
memory and sent with ``non_blocking=True``, so the copy overlaps the work
already queued on the card. uint8 arrays are the [0, 255] image payloads
of ``data_params.device_normalize`` and become float32 / 255 on the
device; only ``image`` and ``input_y`` may be uint8, any other uint8 key
raises. The loop calls it inline, on its own thread: a host thread that
assembles the next batches ahead did not beat the inline copy on the
card (PERF.md, phase "shapes3d" of ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: the only keys that may arrive as uint8 ([0, 255] images)
U8_IMAGE_KEYS = frozenset({"image", "input_y"})


def _check_u8(key: str, arr) -> None:
    if arr.dtype == np.uint8 and key not in U8_IMAGE_KEYS:
        raise TypeError(
            f"batch key {key!r} is uint8, but only {sorted(U8_IMAGE_KEYS)} "
            f"may be uint8 image payloads (data_params.device_normalize); "
            f"give {key!r} its own dtype (int64 labels, float32 actions) "
            f"in the dataset")


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Numpy batch (the ``mode`` string popped) -> tensors on ``device``."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        arr = np.ascontiguousarray(v)
        _check_u8(k, arr)
        t = torch.from_numpy(arr)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if t.dtype == torch.uint8:
            # a true division by a 255 on the device (a Python scalar
            # divisor becomes a multiply by its reciprocal on CUDA), so
            # both devices round as numpy's astype(float32) / 255 does
            t = t.float().div_(torch.full((), 255.0, device=device))
        out[k] = t
    return out
