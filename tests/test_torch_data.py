"""The port's data layer for the image datasets against the JAX package:
the five disent loaders on small stand-ins of each canonical format (the
3dshapes npz converted from the h5 the JAX loader reads), the transform
cache, ``StandardTransform``, the split / transition file generator, the
Shapes3D stand-in renderer, the transition files, the data module on
``Shapes3D`` / ``TShapes3D``, and the host-to-device copy.

Tolerances: factors, indices, actions, schedules and generated files
exactly; images within 1e-6 of the JAX transform's native kernel
(``ctvae_tpu.native``, the same triangle filter in float32 with sums in
another order; pinned by ``jax_native``, as its PIL fallback rounds to
uint8) and within 1/255 + 1e-6 of its per-image PIL path; cached uint8
images within one level.
"""

import filecmp
import os
import struct
import sys

import numpy as np
import pytest
import torch

from ctvae_tpu.data import disent_data as jdd
from ctvae_tpu.data import transforms as jtr
from ctvae_torch.data import disent_data as tdd
from ctvae_torch.data import transforms as ttr
from torch_port_common import _jax_native_lib, jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

IMG_ATOL = 1e-6
SHAPES_GRID = (2, 2, 3, 4, 2, 3)       # 288 images, all six factors


def _close(got, want, atol=IMG_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# --- stand-ins of each canonical format -----------------------------------

def _grid(sizes):
    return np.indices(sizes).reshape(len(sizes), -1).T


def _write_norb(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack("<i", magic))
        f.write(struct.pack("<i", arr.ndim))
        for d in range(max(arr.ndim, 3)):
            f.write(struct.pack("<i", arr.shape[d] if d < arr.ndim else 1))
        f.write(arr.tobytes())


def _make_dsprites(root, rng):
    sizes = (2, 2, 3, 2, 2)
    n = int(np.prod(sizes))
    folder = root / "dsprites"
    folder.mkdir()
    np.savez(folder / "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz",
             imgs=rng.integers(0, 2, (n, 64, 64)).astype(np.uint8),
             latents_classes=np.concatenate(
                 [np.zeros((n, 1), np.int64), _grid(sizes)], axis=1))
    return sizes


def _make_shapes3d(root, rng):
    from make_shapes3d_standin import ensure_shapes3d_standin

    from ctvae_torch.data.standins import shapes3d_h5_to_npz
    ensure_shapes3d_standin(str(root), factor_sizes=SHAPES_GRID,
                            verbose=False)
    shapes3d_h5_to_npz(str(root))
    return SHAPES_GRID


def _make_cars3d(root, rng):
    from scipy.io import savemat
    sizes = (4, 24, 2)
    folder = root / "cars3d" / "cars"
    folder.mkdir(parents=True)
    for c in range(sizes[2]):
        im = rng.integers(0, 256, (128, 128, 3, 24, 4)).astype(np.uint8)
        savemat(folder / f"car_{c:03d}_mesh.mat", {"im": im})
    return sizes


def _make_smallnorb(root, rng):
    sizes = (2, 2, 2, 2, 2)
    n = int(np.prod(sizes))
    grid = _grid(sizes)
    perm = rng.permutation(n)                    # rows not in factor order
    folder = root / "smallnorb"
    folder.mkdir()
    prefix = str(folder / "smallnorb-5x46789x9x18x6x2x96x96-training")
    _write_norb(prefix + "-dat.mat",
                rng.integers(0, 256, (n, 2, 96, 96)).astype(np.uint8),
                0x1E3D4C55)
    _write_norb(prefix + "-cat.mat", grid[perm, 0].astype(np.int32),
                0x1E3D4C54)
    _write_norb(prefix + "-info.mat", grid[perm, 1:].astype(np.int32),
                0x1E3D4C54)
    return sizes


def _make_sprites(root, rng):
    sizes = (2, 2, 1, 1, 1, 1, 2, 1, 2)
    n = int(np.prod(sizes))
    folder = root / "sprites"
    folder.mkdir()
    np.savez(folder / "sprites.npz",
             images=rng.integers(0, 256, (n, 64, 64, 3)).astype(np.uint8),
             factors=_grid(sizes))
    return sizes


MAKERS = {"dsprites": _make_dsprites, "3dshapes": _make_shapes3d,
          "cars3d": _make_cars3d, "smallnorb": _make_smallnorb,
          "sprites": _make_sprites}


def _standin(name, root, monkeypatch):
    """The stand-in of ``name`` under ``root`` with its split file, and
    both packages' FACTOR_SIZES set to its grid."""
    if name == "3dshapes":
        pytest.importorskip("h5py")
    from ctvae_torch.data.variations import generate
    sizes = MAKERS[name](root, np.random.default_rng(len(name)))
    for module in (jdd, tdd):
        monkeypatch.setitem(module.FACTOR_SIZES, name, sizes)
    generate(name, str(root), factor_sizes=sizes)
    return sizes


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_loader_matches_jax(tmp_path, monkeypatch, jax_native, name):
    """Each loader, through its package's StandardTransform(64, 148), on
    every split: the same indices, factors and images."""
    sizes = _standin(name, tmp_path, monkeypatch)
    for split in ("train", "test", "all"):
        j = jdd.DISENT_LOADERS[name](str(tmp_path), split=split,
                                     transform=jtr.StandardTransform(64, 148))
        t = tdd.DISENT_LOADERS[name](str(tmp_path), split=split,
                                     transform=ttr.StandardTransform(64, 148))
        assert t.indices == j.indices and len(t) == len(j) > 0
        assert t.factor_sizes == j.factor_sizes == sizes
        np.testing.assert_array_equal(t.factors_all, j.factors_all)
        idxs = np.random.default_rng(1).permutation(len(t))[:9]
        (ti, tf), (ji, jf) = t.get_batch(idxs), j.get_batch(idxs)
        np.testing.assert_array_equal(tf, jf)
        _close(ti, ji)
        np.testing.assert_array_equal(t.factor_to_index(tf),
                                      j.factor_to_index(jf))
    if name == "3dshapes":       # every label value became its grid index
        np.testing.assert_array_equal(t.factors_all, _grid(sizes))


def test_shapes3d_needs_the_npz(tmp_path):
    """With only the h5, the loader names the converter."""
    folder = tmp_path / "3dshapes"
    folder.mkdir()
    (folder / "3dshapes.h5").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="standins convert"):
        tdd.load_shapes3d(str(tmp_path))


@pytest.mark.parametrize("cache,normalize", [(True, False), (False, True)])
def test_transform_cache_matches_jax(tmp_path, monkeypatch, jax_native,
                                     cache, normalize):
    """``cache_transformed`` / ``device_normalize``: the same uint8 rows
    (rounded as JAX rounds, one level apart at most where the two
    transforms straddle a half) and float images; factors exactly. Each
    package builds its cache from a stand-in of its own (the same bytes),
    since each would map the other's ``tcache_*`` file."""
    roots = {k: tmp_path / k for k in ("jax", "port")}
    for root in roots.values():
        root.mkdir()
        _standin("dsprites", root, monkeypatch)
    kw = dict(split="train", cache_transformed=cache,
              device_normalize=normalize)
    j = jdd.load_dsprites(str(roots["jax"]),
                          transform=jtr.StandardTransform(32, 148), **kw)
    t = tdd.load_dsprites(str(roots["port"]),
                          transform=ttr.StandardTransform(32, 148), **kw)
    assert t.cache_built and t._cache.dtype == np.uint8
    np.testing.assert_allclose(t._cache.astype(int),
                               np.asarray(j._cache).astype(int), atol=1)
    idxs = np.arange(len(t))[::-1]
    (ti, tf), (ji, jf) = t.get_batch(idxs), j.get_batch(idxs)
    np.testing.assert_array_equal(tf, jf)
    assert ti.dtype == (np.uint8 if normalize else np.float32) == ji.dtype
    _close(ti.astype(np.float32), ji.astype(np.float32),
           atol=1.0 if normalize else 1.0 / 255.0 + 1e-6)


# --- the transform -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size,crop,patch", [
    (64, 148, 64),     # Shapes3D, dsprites: the crop pads
    (128, 148, 64),    # cars3d
    (96, 148, 64),     # smallnorb
    (64, None, 32),    # no crop
    (64, 148, 32)])
def test_standard_transform_matches_jax(jax_native, dtype, size, crop,
                                        patch):
    rng = np.random.default_rng(size + patch)
    imgs = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)
    if dtype == np.float32:
        imgs = imgs.astype(np.float32) / 255.0
    j, t = jtr.StandardTransform(patch, crop), ttr.StandardTransform(patch,
                                                                      crop)
    _close(t.batch(imgs), j.batch(imgs))
    _close(t(imgs[0]), j(imgs[0]), atol=1.0 / 255.0 + 1e-6)   # JAX: PIL
    grey = imgs[..., 0]
    _close(t.batch(grey), j.batch(grey))


@pytest.mark.parametrize("size,crop", [(64, 148), (200, 148), (30, 31)])
def test_transform_parts_match_jax(size, crop):
    """``to_float``, ``center_crop`` (exactly) and ``resize`` (JAX: PIL
    per channel, so within 1/255) on one image, and grey images."""
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (size, size + 3, 3)).astype(np.uint8)
    for im in (img, img[..., 0]):
        np.testing.assert_array_equal(ttr.to_float(im), jtr.to_float(im))
    x = jtr.to_float(img)
    np.testing.assert_array_equal(ttr.center_crop(x, crop),
                                  jtr.center_crop(x, crop))
    _close(ttr.resize(x, 24), jtr.resize(x, 24), atol=1.0 / 255.0 + 1e-6)


def test_crop_restricted_matrix_equals_padded_frame():
    """At 64 -> 148 -> 64 the matrix of an axis is [64, 64]: the resize
    of the 148-pixel frame without the columns of the padding, whose
    zeros add nothing."""
    m = ttr.axis_matrix(64, 148, 64)
    full = ttr._triangle_weights(148, 64).astype(np.float32)
    assert m.shape == (64, 64) and not m.flags.writeable
    np.testing.assert_array_equal(m, full[:, 42:106])
    col = np.random.default_rng(0).random(64).astype(np.float32)
    framed = np.zeros(148, np.float32)
    framed[42:106] = col
    np.testing.assert_allclose(m @ col, full @ framed, rtol=1e-6)


# --- the generator and the stand-in renderer ---------------------------------

@pytest.mark.parametrize("name", ["cars3d", "3dshapes"])
def test_variation_generator_writes_the_scripts_bytes(tmp_path, name):
    from disent_variation_gen import generate as jgen

    from ctvae_torch.data.variations import generate
    jgen(name, str(tmp_path / "jax"))
    generate(name, str(tmp_path / "torch"))
    n = len(tdd.FACTOR_SIZES[name])
    for fname in ("list_eval_partition.txt", f"variation_attrs_{n}.txt"):
        assert filecmp.cmp(tmp_path / "jax" / name / fname,
                           tmp_path / "torch" / name / fname, shallow=False)


def test_standin_renderer_is_the_scripts():
    import make_shapes3d_standin as jstand

    from ctvae_torch.data import standins
    rows = np.random.default_rng(0).integers(
        0, tdd.FACTOR_SIZES["3dshapes"], (600, 6))
    np.testing.assert_array_equal(standins.render_chunk(rows),
                                  jstand.render_chunk(rows))
    for a, b in zip(standins.FACTOR_VALUES, jstand.FACTOR_VALUES):
        np.testing.assert_array_equal(a, b)


def test_standin_npz_equals_the_h5(tmp_path):
    """The port's writer (numpy only) and the converter of the JAX
    stand-in's h5 give the same arrays, memory-mapped by the loader."""
    h5py = pytest.importorskip("h5py")
    from make_shapes3d_standin import ensure_shapes3d_standin

    from ctvae_torch.data import standins
    ensure_shapes3d_standin(str(tmp_path / "h5"), factor_sizes=SHAPES_GRID,
                            verbose=False)
    converted = standins.shapes3d_h5_to_npz(str(tmp_path / "h5"), chunk=100)
    written = standins.write_shapes3d_standin(str(tmp_path / "npz"),
                                              SHAPES_GRID, chunk=100)
    for key in ("images", "labels"):
        a = tdd._open_npz_member_mmap(converted, key)
        b = tdd._open_npz_member_mmap(written, key)
        assert isinstance(a, np.memmap) and isinstance(b, np.memmap)
        np.testing.assert_array_equal(a, b)
    with np.load(written) as z:          # a plain npz to numpy as well
        np.testing.assert_array_equal(z["labels"], np.asarray(b))
    assert os.path.exists(tmp_path / "npz" / "3dshapes" /
                          "variation_attrs_6.txt")
    with pytest.raises(ValueError, match="not within"):
        standins.write_shapes3d_standin(str(tmp_path / "x"), (11, 1, 1, 1,
                                                              1, 1))


def test_standin_and_generator_command_lines(tmp_path):
    """``python -m ctvae_torch.data.standins shapes3d`` and ``python -m
    ctvae_torch.data.variations``: the files each writes."""
    from ctvae_torch.data import standins, variations
    root = str(tmp_path)
    standins.main(["shapes3d", "--root", root, "--factor-sizes",
                   "2,2,2,2,2,2"])
    assert sorted(os.listdir(tmp_path / "3dshapes")) == [
        "3dshapes.npz", "list_eval_partition.txt", "variation_attrs_6.txt"]
    assert tdd.load_shapes3d(root, split="all").factors_all.shape == (64, 6)
    variations.main(["dsprites", root, "--factor-sizes", "2,2,2,2,2"])
    assert os.path.exists(tmp_path / "dsprites" / "variation_attrs_5.txt")


def test_convert_command_keeps_existing_files(tmp_path, capsys):
    """``python -m ctvae_torch.data.standins convert`` writes the npz of
    an h5 and leaves split and transition files already there alone."""
    h5py = pytest.importorskip("h5py")
    from make_shapes3d_standin import ensure_shapes3d_standin

    from ctvae_torch.data import standins
    root = str(tmp_path)
    ensure_shapes3d_standin(root, factor_sizes=(2, 2, 2, 2, 2, 2),
                            verbose=False)
    folder = tmp_path / "3dshapes"
    for name in ("list_eval_partition.txt", "variation_attrs_6.txt"):
        (folder / name).write_text("kept\n")
    standins.main(["convert", "--root", root])
    assert "3dshapes.npz" in capsys.readouterr().out
    assert (folder / "list_eval_partition.txt").read_text() == "kept\n"
    with h5py.File(folder / "3dshapes.h5", "r") as f:
        labels = f["labels"][:]
    np.testing.assert_array_equal(
        tdd._open_npz_member_mmap(str(folder / "3dshapes.npz"), "labels"),
        labels)


# --- transitions and the data module -----------------------------------------

@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    """A Shapes3D stand-in in both forms (the JAX h5, the port's npz) with
    the split and transition files of its grid."""
    pytest.importorskip("h5py")
    from ctvae_torch.data.variations import generate
    root = tmp_path_factory.mktemp("shapes")
    _make_shapes3d(root, None)
    generate("3dshapes", str(root), factor_sizes=SHAPES_GRID)
    return str(root)


@pytest.mark.parametrize("split", ["train", "valid", "test", "all"])
def test_transitions_match_jax(shapes_root, jax_native, split):
    from ctvae_tpu.data.transition import TransitionDataset as JTransitions
    from ctvae_torch.data import TransitionDataset
    j = JTransitions(jdd.load_shapes3d(shapes_root, split=split),
                     num_variations=6)
    t = TransitionDataset.from_variation_file(
        tdd.load_shapes3d(shapes_root, split=split), 6)
    assert t.transitions == j.transitions and len(t.transitions) > 0
    np.testing.assert_array_equal(t.actions, j.actions)
    assert t.actions.dtype == np.float32 and t.actions.shape[1] == 12
    assert len(t) == len(j)
    rng = np.random.default_rng(3)
    for mode, rr in t.mode_ranges().items():
        assert rr == j.mode_ranges()[mode]
        idxs = rng.choice(np.array(rr), size=min(5, len(rr)), replace=False)
        got, want = t.get_batch(idxs, mode), j.get_batch(idxs, mode)
        assert got.keys() == want.keys()
        for k in want:
            (_close if k in ("image", "input_y")
             else np.testing.assert_array_equal)(got[k], want[k])


@pytest.mark.parametrize("name,modes", [
    ("TShapes3D", {"base", "action", "causal"}), ("Shapes3D", {"base"})])
def test_datamodule_matches_jax(shapes_root, jax_native, name, modes):
    """The train, val and test loaders of two epochs: the same schedule
    (modes, factors, actions) and images."""
    from ctvae_tpu.data.datamodule import VAEDataset as JVAEDataset
    from ctvae_torch.data import VAEDataset
    args = dict(dataset_name=name, train_batch_size=8, val_batch_size=8,
                patch_size=16, limit=24, val_limit=16, seed=5,
                num_workers=4)
    jd = JVAEDataset(shapes_root, distributed=False, **args)
    td = VAEDataset(shapes_root, **args)
    jd.setup()
    td.setup()
    assert td.steps_per_epoch() == jd.steps_per_epoch() > 0
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        for epoch in (0, 1):
            want = list(getattr(jd, loader)(epoch))
            got = list(getattr(td, loader)(epoch))
            assert len(got) == len(want) > 0
            assert {b["mode"] for b in got} <= modes
            for g, w in zip(got, want):
                assert g.keys() == w.keys() and g["mode"] == w["mode"]
                for k in w:
                    if k in ("image", "input_y"):
                        _close(g[k], w[k])
                    elif k != "mode":
                        np.testing.assert_array_equal(g[k], w[k])
    assert {b["mode"] for b in td.train_dataloader(0)} == modes


def test_datamodule_passes_the_cache_knobs(shapes_root):
    """``data_params.device_normalize`` reaches the loader: uint8 images
    out of the data module, within one level of the float ones."""
    from ctvae_torch.data import VAEDataset
    args = dict(dataset_name="TShapes3D", train_batch_size=8, patch_size=16,
                limit=8, seed=1)
    plain, u8 = (VAEDataset(shapes_root, device_normalize=d, **args)
                 for d in (False, True))
    plain.setup()
    u8.setup()
    for a, b in zip(plain.train_dataloader(0), u8.train_dataloader(0)):
        assert b["image"].dtype == np.uint8 and a["image"].dtype == np.float32
        np.testing.assert_allclose(b["image"] / 255.0, a["image"],
                                   atol=0.5 / 255 + 1e-6)


# --- the host-to-device copy -------------------------------------------------

def test_uint8_copy_equals_host_float_path():
    from ctvae_torch.data.prefetch import to_device
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    got = to_device({"image": u8, "input_y": u8[::-1]}, "cpu")
    host = u8.astype(np.float32) / 255.0       # the host f32 path
    for k, want in (("image", host), ("input_y", host[::-1])):
        assert got[k].dtype == torch.float32
        diff = np.abs(got[k].numpy() - want)
        assert (diff <= np.spacing(want)).all(), k    # one ulp at most
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        to_device({"image": every}, "cpu")["image"].numpy(),
        every.astype(np.float32) / 255.0)


def test_uint8_outside_image_keys_raises():
    from ctvae_torch.data.prefetch import to_device
    bad = {"image": np.zeros((2, 4, 4, 3), np.uint8),
           "labels": np.zeros((2, 6), np.uint8)}
    with pytest.raises(TypeError, match="'labels' is uint8"):
        to_device(bad, "cpu")


def test_to_device_keeps_other_keys_as_they_are():
    """Arrays other than the uint8 images arrive with their own dtype and
    values, non-contiguous ones included."""
    from ctvae_torch.data.prefetch import to_device
    rng = np.random.default_rng(2)
    batch = {"image": rng.random((3, 4, 4, 3), dtype=np.float32),
             "action": rng.random((3, 12), dtype=np.float32)[:, ::2],
             "labels": rng.integers(0, 4, (3, 6))}
    got = to_device(batch, "cpu")
    assert got.keys() == batch.keys()
    for k, want in batch.items():
        assert got[k].dtype == torch.from_numpy(want.copy()).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want)
