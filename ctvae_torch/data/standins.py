"""Stand-ins of the image datasets in the form the port reads: Shapes3D
(``3dshapes/3dshapes.npz``) and CelebA (``celeba/``, JPEGs).

    python -m ctvae_torch.data.standins shapes3d [--root Data/]
        [--factor-sizes 4,4,4,8,4,15]
    python -m ctvae_torch.data.standins convert [--root Data/]
    python -m ctvae_torch.data.standins celeba [--root Data/]
        [--count 202599]

``shapes3d`` renders a stand-in of the dataset (the port's copy of
``scripts/make_shapes3d_standin.py::render_chunk``: hue-coloured floor
and wall, an object whose size, silhouette and position follow the scale,
shape and orientation factors) over the full factor grid, or over a
smaller one that keeps every factor, and writes it straight to the npz
with the real dataset's label values; then the split and
``variation_attrs_6.txt`` of that grid (``data/variations.py``). It
needs numpy only.

``convert`` rewrites a real (or stand-in) ``3dshapes.h5`` as the npz,
chunk by chunk, and writes the split and transition files of the full
grid where they are missing. It needs h5py, which it imports when run.

``celeba`` is the port's copy of ``scripts/make_celeba_standin.py``: the
same file names (``img_align_celeba/000001.jpg`` ...) and
``list_eval_partition.txt`` bytes for the same count, each image rendered
(a gradient background, a skin-tone ellipse and two eyes, 178 x 218)
from a generator seeded by its index and encoded at JPEG quality 80 by
the port's codec (``ctvae_torch/native``: libjpeg writes the script's
bytes; nvJPEG on a machine with a card and no libjpeg). Images are
rendered in a pool of processes; existing files are kept. The script
writes no attributes; ``label_celeba_standin`` writes a split in other
proportions and a seeded attribute file over the images.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import zipfile
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np

from .disent_data import FACTOR_SIZES
from .variations import generate, parse_sizes

FACTOR_VALUES = (
    np.linspace(0.0, 0.9, 10),        # floor_hue
    np.linspace(0.0, 0.9, 10),        # wall_hue
    np.linspace(0.0, 0.9, 10),        # object_hue
    np.linspace(0.75, 1.25, 8),       # scale
    np.arange(4, dtype=np.float64),   # shape
    np.linspace(-30.0, 30.0, 15),     # orientation
)
IMG = 64


def _hue_rgb(h: np.ndarray) -> np.ndarray:
    """Hue in [0, 1) -> RGB in [0, 1], a smooth cosine colour map.
    [N] -> [N, 3]."""
    ang = 2.0 * np.pi * h[:, None] + np.array([0.0, -2.094, -4.188])
    return 0.55 + 0.45 * np.cos(ang)


def render_chunk(factors: np.ndarray) -> np.ndarray:
    """Render [N, 6] factor-index rows to uint8 [N, 64, 64, 3]."""
    f = np.asarray(factors)
    n = len(f)
    floor_rgb = _hue_rgb(FACTOR_VALUES[0][f[:, 0]])
    wall_rgb = _hue_rgb(FACTOR_VALUES[1][f[:, 1]])
    obj_rgb = _hue_rgb(FACTOR_VALUES[2][f[:, 2]])
    scale = FACTOR_VALUES[3][f[:, 3]].astype(np.float32)
    shape_id = f[:, 4].astype(np.int32)
    orient = FACTOR_VALUES[5][f[:, 5]].astype(np.float32)

    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float32) / (IMG - 1)
    img = np.empty((n, IMG, IMG, 3), np.float32)
    # wall above the horizon, floor below, both shaded by height
    horizon = 0.62
    is_floor = (yy >= horizon)[None, :, :, None]
    shade = (0.75 + 0.25 * yy)[None, :, :, None]
    img[:] = np.where(is_floor, floor_rgb[:, None, None, :],
                      wall_rgb[:, None, None, :]) * shade

    # the object: its center follows orientation, its radius scale, its
    # silhouette shape
    cx = 0.5 + 0.25 * np.sin(np.deg2rad(orient))
    cy = horizon - 0.18 * scale
    r = (0.11 + 0.10 * (scale - 0.75))[:, None, None]
    dx = xx[None] - cx[:, None, None]
    dy = yy[None] - cy[:, None, None]
    sph = dx * dx + dy * dy <= r * r
    cube = np.maximum(np.abs(dx), np.abs(dy)) <= 0.9 * r
    cyl = (np.abs(dx) <= 0.8 * r) & (np.abs(dy) <= 1.15 * r)
    capsule = (dx * dx + (0.6 * dy) ** 2) <= r * r
    obj = np.where(shape_id[:, None, None] == 0, sph,
                   np.where(shape_id[:, None, None] == 1, cube,
                            np.where(shape_id[:, None, None] == 2, cyl,
                                     capsule)))
    glow = np.clip(1.0 - (dx * dx + dy * dy) / np.maximum(r * r, 1e-6),
                   0.25, 1.0)
    obj_col = obj_rgb[:, None, None, :] * glow[..., None]
    img = np.where(obj[..., None], obj_col, img)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


Member = Tuple[Tuple[int, ...], np.dtype, Iterable[np.ndarray]]


def write_npz(path: str, members: Dict[str, Member]) -> None:
    """An uncompressed ``.npz`` (as ``np.savez`` writes) of arrays given
    as (shape, dtype, chunks along axis 0), written chunk by chunk so no
    array is held whole; renamed into place when complete."""
    from numpy.lib import format as npf
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, (shape, dtype, chunks) in members.items():
            dtype = np.dtype(dtype)
            want = int(np.prod(shape)) * dtype.itemsize
            written = 0
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                npf.write_array_header_1_0(f, {
                    "descr": npf.dtype_to_descr(dtype),
                    "fortran_order": False, "shape": tuple(shape)})
                for chunk in chunks:
                    data = np.ascontiguousarray(chunk, dtype).tobytes()
                    f.write(data)
                    written += len(data)
            if written != want:
                raise ValueError(f"{name}: {written} bytes written for "
                                 f"{shape} {dtype} ({want})")
    os.replace(tmp, path)


def _grid(factor_sizes: Sequence[int]) -> np.ndarray:
    return np.indices(factor_sizes).reshape(len(factor_sizes), -1).T


def _rendered(grid: np.ndarray, chunk: int) -> Iterator[np.ndarray]:
    """``render_chunk`` of each ``chunk`` rows of ``grid``, in order,
    rendered on a pool of threads (numpy's array work releases the
    interpreter lock) at most a few chunks ahead of the consumer."""
    workers = min(8, len(os.sched_getaffinity(0)))
    with ThreadPoolExecutor(workers) as pool:
        ahead: deque = deque()
        for lo in range(0, len(grid), chunk):
            ahead.append(pool.submit(render_chunk, grid[lo:lo + chunk]))
            if len(ahead) > 2 * workers:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()


def write_shapes3d_standin(data_root: str = "Data/",
                           factor_sizes: Sequence[int] = FACTOR_SIZES[
                               "3dshapes"],
                           chunk: int = 1024) -> str:
    """Render the stand-in over ``factor_sizes`` (each at most the real
    grid's size; the first values of each factor) into
    ``<data_root>/3dshapes/3dshapes.npz`` and write its split and
    transition files; returns the npz's path."""
    sizes = tuple(int(s) for s in factor_sizes)
    real = FACTOR_SIZES["3dshapes"]
    if len(sizes) != len(real) or any(not 0 < s <= r
                                      for s, r in zip(sizes, real)):
        raise ValueError(f"factor sizes {sizes} not within {real}")
    folder = os.path.join(data_root, "3dshapes")
    os.makedirs(folder, exist_ok=True)
    grid = _grid(sizes)
    n = len(grid)
    labels = np.stack([FACTOR_VALUES[i][grid[:, i]]
                       for i in range(len(sizes))], axis=1)
    path = os.path.join(folder, "3dshapes.npz")
    write_npz(path, {
        "images": ((n, IMG, IMG, 3), np.uint8, _rendered(grid, chunk)),
        "labels": (labels.shape, np.float64, [labels])})
    generate("3dshapes", data_root, factor_sizes=sizes)
    return path


def shapes3d_h5_to_npz(data_root: str = "Data/", chunk: int = 8192) -> str:
    """``<data_root>/3dshapes/3dshapes.h5`` -> ``3dshapes.npz`` beside it
    (the same ``images`` and ``labels``); returns the npz's path."""
    import h5py
    folder = os.path.join(data_root, "3dshapes")
    src = os.path.join(folder, "3dshapes.h5")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no {src} to convert")
    path = os.path.join(folder, "3dshapes.npz")
    with h5py.File(src, "r") as f:
        images, labels = f["images"], f["labels"][:]
        n = images.shape[0]
        write_npz(path, {
            "images": (images.shape, np.uint8,
                       (images[lo:lo + chunk] for lo in range(0, n, chunk))),
            "labels": (labels.shape, labels.dtype, [labels])})
    return path


CELEBA_COUNT = 202_599
CELEBA_H, CELEBA_W = 218, 178
# torchvision's CelebA split (list_eval_partition.txt): 1-162770 train,
# 162771-182637 valid, 182638-202599 test
CELEBA_TRAIN_END, CELEBA_VALID_END = 162_770, 182_637
CELEBA_QUALITY = 80
CELEBA_CHUNK = 256      # images per task of the render pool
# label_celeba_standin's split: train and valid fractions, torchvision's
# proportions (the rest is test)
CELEBA_LABELLED_SPLIT = (0.8, 0.1)


def render_celeba(idx: int, rng: np.random.Generator) -> np.ndarray:
    """One 218 x 178 uint8 RGB face-ish image (``idx`` is unused: the
    generator carries the image's seed)."""
    yy, xx = np.mgrid[0:CELEBA_H, 0:CELEBA_W].astype(np.float32)
    bg = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    img = (bg[None, None] * (0.6 + 0.4 * (yy / CELEBA_H)[..., None]))
    cx, cy = rng.uniform(60, 118), rng.uniform(80, 140)
    a, b = rng.uniform(38, 55), rng.uniform(50, 72)
    face = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1.0
    tone = np.array([0.85, 0.65, 0.5], np.float32) * rng.uniform(0.6, 1.1)
    img[face] = tone
    for dx in (-0.35, 0.35):
        ex, ey = cx + dx * a, cy - 0.25 * b
        eye = ((xx - ex) / 6) ** 2 + ((yy - ey) / 4) ** 2 <= 1.0
        img[eye] = 0.08
    noise = rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip((img + noise) * 255.0, 0, 255).astype(np.uint8)


def render_celeba_images(indices: Sequence[int]) -> np.ndarray:
    """``render_celeba`` of each index with its own seed, [n, 218, 178,
    3]: an image's pixels depend on its index alone."""
    return np.stack([render_celeba(i, np.random.default_rng(i))
                     for i in indices])


def ensure_celeba_standin(data_root: str = "Data/",
                          count: int = CELEBA_COUNT,
                          verbose: bool = True) -> str:
    """Write the first ``count`` images of the stand-in under
    ``<data_root>/celeba/img_align_celeba`` (those missing) and, when it
    is missing, ``list_eval_partition.txt`` (torchvision's split: below
    162,771 images all are train); returns the folder. A pool of as many
    processes as cores (at most 8) renders them, unless they fit one
    chunk."""
    from .. import native
    folder = os.path.join(data_root, "celeba")
    img_dir = os.path.join(folder, "img_align_celeba")
    os.makedirs(img_dir, exist_ok=True)
    part_file = os.path.join(folder, "list_eval_partition.txt")
    if not os.path.exists(part_file):
        with open(part_file, "w") as f:
            for i in range(1, count + 1):
                split = 0 if i <= CELEBA_TRAIN_END else (
                    1 if i <= CELEBA_VALID_END else 2)
                f.write(f"{i:06d}.jpg {split}\n")
    todo = [i for i in range(1, count + 1)
            if not os.path.exists(os.path.join(img_dir, f"{i:06d}.jpg"))]
    chunks = [todo[k:k + CELEBA_CHUNK]
              for k in range(0, len(todo), CELEBA_CHUNK)]
    codec = native.codec()

    def write(chunk, images):
        codec.encode_batch(images, [os.path.join(img_dir, f"{i:06d}.jpg")
                                    for i in chunk], CELEBA_QUALITY)

    workers = min(8, len(os.sched_getaffinity(0)))
    if len(chunks) <= 1 or workers <= 1:
        for chunk in chunks:
            write(chunk, render_celeba_images(chunk))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            for chunk, images in zip(chunks, pool.map(render_celeba_images,
                                                      chunks)):
                write(chunk, images)
    if verbose:
        print(f"=> {img_dir}: {count} images ready ({len(todo)} new, "
              f"{codec.version})")
    return folder


def label_celeba_standin(data_root: str, count: int) -> Dict[str, int]:
    """Over the stand-in's first ``count`` images: a
    ``list_eval_partition.txt`` of the first 80% train, the next 10%
    valid and the rest test (CELEBA_LABELLED_SPLIT; it replaces the
    script's, whose split puts all of a small stand-in in train), and a
    ``list_attr_celeba.txt`` of 40 +-1 attributes drawn with seed 0, each
    odd image a copy of the one before with attribute 0 flipped. Returns
    the size of each split."""
    folder = os.path.join(data_root, "celeba")
    n_train = int(round(count * CELEBA_LABELLED_SPLIT[0]))
    n_valid = int(round(count * CELEBA_LABELLED_SPLIT[1]))
    names = [f"{i:06d}.jpg" for i in range(1, count + 1)]
    with open(os.path.join(folder, "list_eval_partition.txt"), "w") as f:
        for i, name in enumerate(names):
            split = 0 if i < n_train else 1 if i < n_train + n_valid else 2
            f.write(f"{name} {split}\n")
    rng = np.random.default_rng(0)
    attrs = rng.choice([-1, 1], size=(count, 40))
    attrs[1::2] = attrs[0:count - 1:2]
    attrs[1::2, 0] = -attrs[1::2, 0]
    with open(os.path.join(folder, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{count}\n")
        f.write(" ".join(f"attr_{j}" for j in range(40)) + "\n")
        for name, row in zip(names, attrs):
            f.write(name + " " + " ".join(str(v) for v in row) + "\n")
    return {"train": n_train, "valid": n_valid,
            "test": count - n_train - n_valid}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("shapes3d", "convert", "celeba"))
    parser.add_argument("--root", default="Data/")
    parser.add_argument("--count", type=int, default=CELEBA_COUNT,
                        help="celeba: images to write (default: CelebA's "
                             "202,599)")
    parser.add_argument("--factor-sizes", default=None,
                        help="shapes3d: the grid, comma-separated "
                             "(default: the real 10,10,10,8,4,15)")
    args = parser.parse_args(argv)
    if args.what == "celeba":
        ensure_celeba_standin(args.root, args.count)
        return
    if args.what == "shapes3d":
        path = write_shapes3d_standin(
            args.root, parse_sizes(args.factor_sizes)
            or FACTOR_SIZES["3dshapes"])
    else:
        path = shapes3d_h5_to_npz(args.root)
        folder = os.path.dirname(path)
        if not all(os.path.exists(os.path.join(folder, name)) for name in
                   ("list_eval_partition.txt", "variation_attrs_6.txt")):
            generate("3dshapes", args.root)
    print(f"=> {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
