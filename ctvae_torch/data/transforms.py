"""Host-side image transforms (numpy arrays in and out), NHWC float32 in
[0, 1].

Counterpart of ``ctvae_tpu/data/transforms.py``: ToTensor ->
CenterCrop(crop) -> Resize(patch) for every image dataset. The center
crop pads with zeros when the crop is larger than the image, as
torchvision's does (64 x 64 Shapes3D images become a 148-pixel frame).
The resize is PIL's antialiased triangle (bilinear) filter, written as
one weight matrix per axis; the crop and its padding are folded into the
matrices, so a batch is two small products (at 64 -> 148 -> 64 a [64, 64]
one per axis) and needs no PIL.

The products run in torch on the CPU, on the calling thread (the
training loop's: the loader runs inline) and torch's own thread pool;
the thread settings are left as the caller has them.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float -> float32 [0, 1]; a channel axis is added
    to grey images ([..., H, W] with no channel axis stays as given: call
    on HWC or HW arrays)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _crop_source(n: int, crop: Optional[int]) -> np.ndarray:
    """For each position of one axis after the center crop, the index of
    the image row it shows, or -1 where the crop pads."""
    if not crop:
        return np.arange(n)
    if n < crop:
        src = np.full(crop, -1)
        top = (crop - n) // 2
        src[top:top + n] = np.arange(n)
        return src
    top = (n - crop) // 2
    return np.arange(top, top + crop)


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """PIL's antialiased bilinear resampling of ``n_in`` samples to
    ``n_out`` as a [n_out, n_in] float64 matrix: output x covers input
    center (x + 0.5) * scale with a triangle of half-width
    max(scale, 1), each row normalised to sum 1."""
    if n_in == n_out:
        return np.eye(n_out)
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for x in range(n_out):
        center = (x + 0.5) * scale
        lo = max(0, int(center - support + 0.5))
        hi = min(n_in, int(center + support + 0.5))
        j = np.arange(lo, hi)
        d = np.abs((j + 0.5 - center) / support)
        row = np.where(d < 1.0, 1.0 - d, 0.0)
        total = row.sum()
        if total <= 0.0:
            row[0], total = 1.0, 1.0
        w[x, lo:hi] = row / total
    return w


@functools.lru_cache(maxsize=64)
def axis_matrix(n: int, crop: Optional[int], n_out: int) -> np.ndarray:
    """The [n_out, n] float32 matrix that center-crops one axis of ``n``
    samples to ``crop`` (zero-padding) and resizes it to ``n_out``: the
    resize's columns of the padded positions are dropped, those of the
    image's rows kept. Cached per (n, crop, n_out); read-only."""
    src = _crop_source(n, crop)
    w = _triangle_weights(len(src), n_out).astype(np.float32)
    m = np.zeros((n_out, n), np.float32)
    live = src >= 0
    m[:, src[live]] = w[:, live]
    m.setflags(write=False)
    return m


def _size2(size: Union[int, Sequence[int]]):
    return (size, size) if isinstance(size, int) else tuple(size)


def crop_resize(imgs: np.ndarray, crop: Optional[int],
                size: Union[int, Sequence[int]]) -> np.ndarray:
    """[N, H, W, C] uint8 or float -> [N, h, w, C] float32: to [0, 1],
    center crop to ``crop`` (None: no crop), resize to ``size``."""
    h, w = _size2(size)
    n, H, W, C = imgs.shape
    mh = torch.from_numpy(axis_matrix(H, crop, h).copy())
    mw = torch.from_numpy(axis_matrix(W, crop, w).copy())
    x = torch.from_numpy(np.ascontiguousarray(imgs)).float()
    if imgs.dtype == np.uint8:
        x = x / 255.0
    rows = torch.matmul(mh, x.reshape(n, H, W * C))      # [N, h, W C]
    out = torch.matmul(mw, rows.reshape(n * h, W, C))    # [N h, w, C]
    return out.reshape(n, h, w, C).numpy()


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision-compatible center crop of one HWC image: crops when
    larger, zero-pads when smaller."""
    h, w, c = img.shape
    out = np.zeros((size, size, c), img.dtype)
    sh, sw = _crop_source(h, size), _crop_source(w, size)
    out[np.ix_(sh >= 0, sw >= 0)] = img[np.ix_(sh[sh >= 0], sw[sw >= 0])]
    return out


def resize(img: np.ndarray, size: Union[int, Sequence[int]]) -> np.ndarray:
    """Antialiased bilinear resize of one HWC float image."""
    return crop_resize(img[None], None, size)[0]


class StandardTransform:
    """ToTensor -> CenterCrop(crop) -> Resize(patch_size), over a batch."""

    def __init__(self, patch_size: Union[int, Sequence[int]] = 64,
                 crop: Optional[int] = 148):
        self.patch_size = patch_size
        self.crop = crop

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self.batch(np.asarray(img)[None])[0]

    def batch(self, imgs: np.ndarray) -> np.ndarray:
        """[N, H, W(, C)] uint8 or float -> [N, h, w, C] float32 [0, 1]."""
        imgs = np.asarray(imgs)
        return crop_resize(imgs[..., None] if imgs.ndim == 3 else imgs,
                           self.crop, self.patch_size)
