"""Loaders of the disent-family factor datasets.

Counterpart of ``ctvae_tpu/data/disent_data.py``. Each loader reads the
dataset's canonical files from ``<data_dir>/<name>/`` (nothing is
downloaded; a missing file raises ``FileNotFoundError``):

* dsprites: ``dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz``;
* 3dshapes: ``3dshapes.npz``, uncompressed, with the two datasets of the
  canonical ``3dshapes.h5`` under the same names (``images`` uint8
  [N, 64, 64, 3], ``labels`` float64 [N, 6]). The port reads no HDF5:
  ``python -m ctvae_torch.data.standins convert`` writes the npz from the
  h5 where h5py is installed;
* cars3d: ``cars/*.mat`` (24 x 4 views per car);
* smallnorb: the ``*-{dat,cat,info}.mat`` binary matrices;
* sprites: ``sprites.npz`` with ``images`` [N, H, W, C] and ``factors``
  [N, 9].

Each gives an ``ArrayFactorDataset``: ``split`` / ``root`` /
``base_folder`` / ``indices`` for the transition wrapper, the factors and
``factor_sizes``, and a vectorised ``get_batch``. Splits come from
``list_eval_partition.txt`` (rows of ``_, index, split`` with 0 / 1 / 2 =
train / valid / test); without one every split is the whole dataset.

``cache_transformed`` transforms the split once into a uint8 array held
in memory, so a batch is a gather; ``device_normalize`` returns those
uint8 rows from ``get_batch`` and leaves the /255 to the device
(``data/prefetch.py``). The JAX package also keeps that cache on disk
(``tcache_*`` files); the port does not yet (ROADMAP A2).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from .transforms import StandardTransform

FACTOR_NAMES = {
    "cars3d": ("elevation", "azimuth", "object_type"),
    "dsprites": ("shape", "scale", "orientation", "position_x", "position_y"),
    "smallnorb": ("category", "instance", "elevation", "rotation", "lighting"),
    "3dshapes": ("floor_hue", "wall_hue", "object_hue", "scale", "shape",
                 "orientation"),
    "sprites": ("bottomwear", "topwear", "hair", "eyes", "shoes", "body",
                "action", "rotation", "frame"),
}

FACTOR_SIZES = {
    "cars3d": (4, 24, 183),
    "dsprites": (3, 6, 40, 32, 32),
    "smallnorb": (5, 5, 9, 18, 6),
    "3dshapes": (10, 10, 10, 8, 4, 15),
    "sprites": (7, 7, 10, 5, 3, 4, 9, 4, 6),
}

SHAPES3D_CONVERT = "python -m ctvae_torch.data.standins convert"


def _open_npz_member_mmap(path: str, key: str) -> np.ndarray:
    """A memory map of member ``key`` of an uncompressed ``.npz``.

    ``np.load(..., mmap_mode=...)`` reads npz members whole. A stored
    (not deflated) member is the raw ``.npy`` bytes at a fixed offset, so
    it is mapped there: the npy header is parsed through the zip stream
    and the data offset found from the member's local file header. A
    compressed or Fortran-ordered member is read whole."""
    import zipfile

    from numpy.lib import format as npf
    name = key + ".npy"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name)
        if info.compress_type != zipfile.ZIP_STORED:
            return np.load(path, allow_pickle=False)[key]
        with zf.open(name) as f:
            read_header = {(1, 0): npf.read_array_header_1_0,
                           (2, 0): npf.read_array_header_2_0}.get(
                npf.read_magic(f))
            if read_header is None:        # a version-3 (utf-8) header
                return np.load(path, allow_pickle=False)[key]
            shape, fortran, dtype = read_header(f)
            header_len = f.tell()
    if fortran or dtype.hasobject:
        return np.load(path, allow_pickle=False)[key]
    with open(path, "rb") as raw:
        raw.seek(info.header_offset)
        lh = raw.read(30)                  # the zip local file header
        if lh[:4] != b"PK\x03\x04":
            return np.load(path, allow_pickle=False)[key]
        nlen = int.from_bytes(lh[26:28], "little")
        elen = int.from_bytes(lh[28:30], "little")
    data_off = info.header_offset + 30 + nlen + elen + header_len
    return np.memmap(path, dtype=dtype, mode="r", offset=data_off,
                     shape=shape)


def _load_split_csv(path: str) -> Tuple[List[int], List[int]]:
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return [int(r[1]) for r in rows], [int(r[2]) for r in rows]


class ArrayFactorDataset:
    """Images (in memory or memory-mapped) with integer factor labels."""

    def __init__(self, images, factors: np.ndarray,
                 factor_sizes: Tuple[int, ...], data_dir: str,
                 base_folder: str, split: str = "train",
                 transform: Optional[StandardTransform] = None,
                 cache_transformed: bool = False,
                 device_normalize: bool = False):
        self.images_raw = images
        self.factors_all = np.asarray(factors).astype(np.int64)
        self.factor_sizes = tuple(factor_sizes)
        self.root = data_dir
        self.base_folder = base_folder
        self.split = split
        self.transform = transform or StandardTransform(64)
        # the whole (unsplit) dataset, for the disentanglement metrics
        self._full_data = self

        split_file = os.path.join(data_dir, base_folder,
                                  "list_eval_partition.txt")
        n = len(images)
        if split == "all" or not os.path.exists(split_file):
            self.index_map = np.arange(n)
        else:
            idx, spl = _load_split_csv(split_file)
            want = {"train": 0, "valid": 1, "test": 2}[split]
            self.index_map = np.array(
                [i for i, s in zip(idx, spl) if s == want], np.int64)
        self.indices = [str(i) for i in self.index_map]

        self.device_normalize = bool(device_normalize)
        self._cache: Optional[np.ndarray] = None
        if cache_transformed or self.device_normalize:
            self._build_cache()

    def _rows(self, raws: np.ndarray) -> np.ndarray:
        return np.asarray(self.images_raw[np.asarray(raws)])

    def _build_cache(self, chunk: int = 4096) -> None:
        """The split transformed once, rounded to uint8 as the JAX cache
        is (``clip(x * 255 + 0.5)``, truncated)."""
        n = len(self.index_map)
        first = self.transform.batch(self._rows(self.index_map[:1]))
        out = np.empty((n,) + first.shape[1:], np.uint8)
        for lo in range(0, n, chunk):
            raws = self.index_map[lo:lo + chunk]
            out[lo:lo + len(raws)] = np.clip(
                self.transform.batch(self._rows(raws)) * 255.0 + 0.5, 0, 255)
        self._cache = out

    def __len__(self) -> int:
        return len(self.index_map)

    def get_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Images [B, h, w, C] (float32 in [0, 1], or the cached uint8
        rows under ``device_normalize``) and factors [B, F] int64."""
        idxs = np.asarray(idxs)
        raws = self.index_map[idxs]
        if self._cache is not None:
            rows = self._cache[idxs]
            if not self.device_normalize:
                rows = rows.astype(np.float32) / 255.0
            return rows, self.factors_all[raws]
        return self.transform.batch(self._rows(raws)), self.factors_all[raws]

    def factor_to_index(self, factors: np.ndarray) -> np.ndarray:
        """Row-major factor tuple -> raw dataset index (the order every
        one of these datasets is stored in)."""
        strides = np.cumprod((1,) + self.factor_sizes[::-1][:-1])[::-1]
        return (np.asarray(factors) * strides).sum(-1).astype(np.int64)


class _ScaledU8Rows:
    """``arr[i] * scale`` row by row, so the 3 GB dsprites archive stays
    memory-mapped (its pixels are 0 / 1)."""

    def __init__(self, arr, scale: int):
        self.arr = arr
        self.scale = np.uint8(scale)

    def __len__(self) -> int:
        return len(self.arr)

    def __getitem__(self, i):
        return np.asarray(self.arr[i]) * self.scale


def _missing(path: str, name: str, hint: str = "") -> None:
    raise FileNotFoundError(
        f"{name} file not found at {path}. Place the dataset's canonical "
        f"file(s) there; nothing is downloaded.{hint}")


def _dataset(images, factors, name: str, data_dir: str, split: str,
             transform, kw, sizes=None) -> ArrayFactorDataset:
    return ArrayFactorDataset(
        images, factors, sizes or FACTOR_SIZES[name], data_dir, name, split,
        transform, cache_transformed=kw.get("cache_transformed", False),
        device_normalize=kw.get("device_normalize", False))


def load_dsprites(data_dir: str, split: str = "train",
                  transform: Optional[StandardTransform] = None, **kw):
    path = os.path.join(data_dir, "dsprites",
                        "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz")
    if not os.path.exists(path):
        _missing(path, "dsprites")
    imgs = _open_npz_member_mmap(path, "imgs")        # [737280, 64, 64] {0,1}
    # column 0 of latents_classes is the constant colour; disent drops it
    factors = np.asarray(_open_npz_member_mmap(path, "latents_classes"))[:, 1:]
    return _dataset(_ScaledU8Rows(imgs, 255), factors, "dsprites", data_dir,
                    split, transform, kw)


def load_shapes3d(data_dir: str, split: str = "train",
                  transform: Optional[StandardTransform] = None, **kw):
    folder = os.path.join(data_dir, "3dshapes")
    path = os.path.join(folder, "3dshapes.npz")
    if not os.path.exists(path):
        h5 = os.path.join(folder, "3dshapes.h5")
        _missing(path, "3dshapes", (
            f" {h5} is there: convert it with `{SHAPES3D_CONVERT} "
            f"--root {data_dir}` where h5py is installed."
            if os.path.exists(h5) else ""))
    imgs = _open_npz_member_mmap(path, "images")      # uint8 [N, 64, 64, 3]
    labels = np.asarray(_open_npz_member_mmap(path, "labels"))
    factors = np.zeros((len(labels), labels.shape[1]), np.int64)
    sizes = []
    for i in range(labels.shape[1]):
        vals = np.unique(labels[:, i])
        factors[:, i] = np.searchsorted(vals, labels[:, i])
        sizes.append(len(vals))
    # the grid the archive holds: the real one's (10, 10, 10, 8, 4, 15), a
    # stand-in's own, so factor_to_index (the metrics' sampler) stays in it
    return _dataset(imgs, factors, "3dshapes", data_dir, split, transform, kw,
                    sizes=tuple(sizes))


def load_cars3d(data_dir: str, split: str = "train",
                transform: Optional[StandardTransform] = None, **kw):
    from scipy.io import loadmat
    folder = os.path.join(data_dir, "cars3d", "cars")
    if not os.path.isdir(folder):
        _missing(folder, "cars3d")
    ims = []
    for m in sorted(f for f in os.listdir(folder) if f.endswith(".mat")):
        data = loadmat(os.path.join(folder, m))["im"]  # [128,128,3,24,4]
        ims.append(data.transpose(4, 3, 0, 1, 2))      # [4,24,128,128,3]
    arr = np.stack(ims).transpose(1, 2, 0, 3, 4, 5)    # [4,24,cars,...]
    sizes = FACTOR_SIZES["cars3d"]
    grid = np.indices(sizes).reshape(len(sizes), -1).T
    return _dataset(arr.reshape(-1, 128, 128, 3), grid, "cars3d", data_dir,
                    split, transform, kw)


def _read_norb_matrix(path: str) -> np.ndarray:
    """smallNORB's binary matrix format."""
    with open(path, "rb") as f:
        magic = int.from_bytes(f.read(4), "little")
        ndim = int.from_bytes(f.read(4), "little")
        shape = [int.from_bytes(f.read(4), "little")
                 for _ in range(max(ndim, 3))][:ndim]
        dtype = {0x1E3D4C51: np.float32, 0x1E3D4C53: np.float64,
                 0x1E3D4C54: np.int32, 0x1E3D4C55: np.uint8,
                 0x1E3D4C56: np.int16}[magic]
        return np.frombuffer(f.read(), dtype).reshape(shape)


def load_smallnorb(data_dir: str, split: str = "train",
                   transform: Optional[StandardTransform] = None, **kw):
    prefix = os.path.join(data_dir, "smallnorb",
                          "smallnorb-5x46789x9x18x6x2x96x96-training")
    if not os.path.exists(prefix + "-dat.mat"):
        _missing(prefix + "-dat.mat", "smallnorb")
    dat = _read_norb_matrix(prefix + "-dat.mat")[:, 0]     # first camera
    cat = _read_norb_matrix(prefix + "-cat.mat")
    info = _read_norb_matrix(prefix + "-info.mat")
    factors = np.column_stack([cat, info[:, 0], info[:, 1], info[:, 2],
                               info[:, 3]]).astype(np.int64)
    order = np.lexsort(factors.T[::-1])
    return _dataset(dat[order], factors[order], "smallnorb", data_dir, split,
                    transform, kw)


def load_sprites(data_dir: str, split: str = "train",
                 transform: Optional[StandardTransform] = None, **kw):
    path = os.path.join(data_dir, "sprites", "sprites.npz")
    if not os.path.exists(path):
        _missing(path, "sprites")
    return _dataset(_open_npz_member_mmap(path, "images"),
                    np.asarray(_open_npz_member_mmap(path, "factors")),
                    "sprites", data_dir, split, transform, kw)


DISENT_LOADERS = {
    "cars3d": load_cars3d,
    "dsprites": load_dsprites,
    "smallnorb": load_smallnorb,
    "3dshapes": load_shapes3d,
    "sprites": load_sprites,
}
