"""Synthetic in-memory datasets (numpy), the port's own copy.

Counterpart of ``ctvae_tpu/data/synthetic.py``: procedurally rendered
images (a coloured rectangle over a gradient) with factor labels, and the
complete factor grid whose one-factor neighbours are the causal transition
pairs of ``TSynthetic``. Every array is a pure function of the arguments,
so the two packages give the same images, factors and pairs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

GRID_FACTOR_SIZES = (5, 5, 3, 4)   # x-pos, y-pos, scale, hue


def render_factor_images(factors: np.ndarray, img_size: int = 64,
                         channels: int = 3,
                         factor_sizes=GRID_FACTOR_SIZES) -> np.ndarray:
    """[N, 4] factor rows (x, y, scale, hue) -> [N, H, W, C] float32."""
    sx, sy, ss, sh = factor_sizes
    n = len(factors)
    imgs = np.zeros((n, img_size, img_size, channels), np.float32)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    for i, (fx, fy, fs, fh) in enumerate(factors):
        base = 0.25 + 0.5 * (xx * ((fh % 3) + 1) / 3.0)
        img = np.stack([base * (0.5 + 0.5 * (c == fh % channels))
                        for c in range(channels)], axis=-1)
        cx = int((fx + 0.5) * img_size / sx)
        cy = int((fy + 0.5) * img_size / sy)
        half = max(1, img_size // 16) * (1 + int(fs))
        x0, x1 = max(0, cx - half), min(img_size, cx + half)
        y0, y1 = max(0, cy - half), min(img_size, cy + half)
        img[y0:y1, x0:x1, :] = (fh + 1) / sh
        imgs[i] = img
    return imgs


def render_random_family(factors: np.ndarray, img_size: int = 64,
                         channels: int = 3) -> np.ndarray:
    """[N, 4] (x-pos/8, y-pos/8, scale/4, hue/6) factor rows -> images."""
    factors = np.asarray(factors)
    n = len(factors)
    imgs = np.zeros((n, img_size, img_size, channels), np.float32)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    for i, (fx, fy, fs, fh) in enumerate(factors):
        base = 0.25 + 0.5 * (xx * ((fh % 3) + 1) / 3.0)
        img = np.stack([base * (0.5 + 0.5 * (c == fh % channels))
                        for c in range(channels)], axis=-1)
        cx = int((fx + 0.5) * img_size / 8)
        cy = int((fy + 0.5) * img_size / 8)
        half = 3 + 2 * int(fs)
        x0, x1 = max(0, cx - half), min(img_size, cx + half)
        y0, y1 = max(0, cy - half), min(img_size, cy + half)
        img[y0:y1, x0:x1, :] = (fh + 1) / 6.0
        imgs[i] = img
    return imgs


def make_synthetic_images(n: int, img_size: int = 64, channels: int = 3,
                          seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(images [n,H,W,C] float32 in [0,1], factors [n,4] int64)."""
    rng = np.random.default_rng(seed)
    factors = np.stack([rng.integers(0, 8, n), rng.integers(0, 8, n),
                        rng.integers(0, 4, n), rng.integers(0, 6, n)],
                       axis=1).astype(np.int64)
    return render_random_family(factors, img_size, channels), factors


class SyntheticDataset:
    """``n`` random-factor images, the first 80% ``train``, the rest
    another split; ``get_batch`` returns (images, factors)."""

    def __init__(self, n: int = 256, img_size: int = 64, channels: int = 3,
                 split: str = "train", seed: int = 0):
        all_imgs, all_factors = make_synthetic_images(n, img_size, channels,
                                                      seed)
        sl = slice(0, int(n * 0.8)) if split == "train" else slice(
            int(n * 0.8), n)
        self.images = all_imgs[sl]
        self.factors = all_factors[sl]
        self.split = split
        self.indices = [str(i) for i in range(len(self.images))]
        self.factor_sizes = (8, 8, 4, 6)
        self._full_data = self

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        return self.images[idx], self.factors[idx]

    def get_batch(self, idxs):
        idxs = np.asarray(idxs)
        return self.images[idxs], self.factors[idxs]


class SyntheticGridDataset:
    """The complete factor grid (row-major) of rendered images, split in
    contiguous chunks at ``split_cuts``; item names are raw grid rows."""

    def __init__(self, img_size: int = 64, channels: int = 3,
                 split: str = "train", factor_sizes=GRID_FACTOR_SIZES,
                 split_cuts: Tuple[float, float] = (0.7, 0.85)):
        self.factor_sizes = tuple(factor_sizes)
        grid = np.indices(self.factor_sizes).reshape(
            len(self.factor_sizes), -1).T
        all_imgs = render_factor_images(grid, img_size, channels,
                                        self.factor_sizes)
        n = len(grid)
        split_ids = np.zeros(n, np.int64)
        split_ids[int(n * split_cuts[0]): int(n * split_cuts[1])] = 1
        split_ids[int(n * split_cuts[1]):] = 2
        want = {"train": (0,), "valid": (1,), "test": (2,),
                "all": (0, 1, 2)}[split]
        keep = np.array([i for i in range(n) if split_ids[i] in want])
        self.raw_index = keep
        self.images = all_imgs[keep]
        self.factors = grid[keep]
        self.split = split
        self.indices = [str(int(i)) for i in keep]
        self._full_data = self

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        return self.images[idx], self.factors[idx]

    def get_batch(self, idxs):
        idxs = np.asarray(idxs)
        return self.images[idxs], self.factors[idxs]

    def causal_transitions(self):
        """Same-split pairs of grid rows differing by +-1 in exactly one
        factor, with 2F-dim one-hot actions (direction * F + factor)."""
        F = len(self.factor_sizes)
        raw_to_local = {int(r): i for i, r in enumerate(self.raw_index)}
        strides = np.cumprod((1,) + self.factor_sizes[::-1][:-1])[::-1]
        pairs, actions = [], []
        for raw, fac in zip(self.raw_index, self.factors):
            for f in range(F):
                if fac[f] + 1 >= self.factor_sizes[f]:
                    continue
                raw_to = int(raw + strides[f])
                if raw_to not in raw_to_local:
                    continue
                for direction, (a, b) in enumerate(((raw, raw_to),
                                                    (raw_to, raw))):
                    act = np.zeros(2 * F, np.float32)
                    act[direction * F + f] = 1.0
                    pairs.append((str(int(a)), str(int(b))))
                    actions.append(act)
        return pairs, (np.stack(actions) if actions
                       else np.zeros((0, 2 * F), np.float32))
