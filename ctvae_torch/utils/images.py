"""Image grids and PNG files (the torchvision ``save_image`` analogue).

Counterpart of ``ctvae_tpu/utils/images.py``. Images are NHWC float in
[0, 1]. The PNG is written with ``zlib`` and ``struct`` of the standard
library, so it needs no imaging package.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 12, padding: int = 2,
              pad_value: float = 0.0, normalize: bool = False) -> np.ndarray:
    """Tile [B, H, W, C] into one [H', W', C] grid, ``nrow`` images per row.

    ``normalize=True`` min-max rescales the whole batch to [0, 1]."""
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:  # single image
        images = images[None]
    if images.shape[-1] not in (1, 3, 4):  # NCHW slipped in; transpose
        images = np.transpose(images, (0, 2, 3, 1))
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-8)
    b, h, w, c = images.shape
    nrow = max(1, min(nrow, b))
    ncol = math.ceil(b / nrow)
    grid = np.full((ncol * (h + padding) + padding,
                    nrow * (w + padding) + padding, c),
                   pad_value, dtype=np.float32)
    for i in range(b):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit PNG of ``arr`` uint8 [H, W] (grey), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA): one IDAT of unfiltered scanlines."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] in (3, 4):
        color = 2 if arr.shape[-1] == 3 else 6
    else:
        raise ValueError(f"no PNG colour type for shape {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str, nrow: int = 12,
               padding: int = 2, normalize: bool = False) -> None:
    """Save a batch as a PNG grid."""
    arr = to_uint8(make_grid(images, nrow=nrow, padding=padding,
                             normalize=normalize))
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(arr))
