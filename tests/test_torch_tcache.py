"""The transform cache on disk (``tcache_*`` files) of the port's disent
loaders against the JAX package's: the same file names and format, the
file the port writes against the one JAX writes (uint8 rows within one
level, as ``tests/test_torch_data.py::test_transform_cache_matches_jax``
holds the in-memory rows; the fingerprint and row count exactly), a
JAX-written cache read by the port bit for bit, a reopen that runs no
transform, the stale guards (row count, a same-length swap of the
dataset's file), and a dataset with no folder on disk, whose cache stays
in memory as JAX's does. On a dsprites stand-in of 48 images.
"""

import json
import os

import numpy as np
import pytest

from ctvae_tpu.data import disent_data as jdd
from ctvae_tpu.data import transforms as jtr
from ctvae_torch.data import disent_data as tdd
from ctvae_torch.data import transforms as ttr
from torch_port_common import _jax_native_lib, jax_native  # noqa: F401

SIZES = (2, 2, 3, 2, 2)
NPZ = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
CACHE = "tcache_train_c148_32.npy"


def _dsprites(root, seed=0):
    """A dsprites stand-in of the SIZES grid under ``root`` (no split file:
    every split is the whole set). The same seed writes the same bytes."""
    n = int(np.prod(SIZES))
    folder = root / "dsprites"
    folder.mkdir(parents=True, exist_ok=True)
    grid = np.indices(SIZES).reshape(len(SIZES), -1).T
    np.savez(folder / NPZ, imgs=np.random.default_rng(seed).integers(
        0, 2, (n, 64, 64)).astype(np.uint8),
        latents_classes=np.concatenate([np.zeros((n, 1), np.int64), grid],
                                       axis=1))
    return folder


@pytest.fixture
def sizes(monkeypatch):
    for module in (jdd, tdd):
        monkeypatch.setitem(module.FACTOR_SIZES, "dsprites", SIZES)


def _port(root):
    return tdd.load_dsprites(str(root), transform=ttr.StandardTransform(
        32, 148), cache_transformed=True)


def _jax(root):
    return jdd.load_dsprites(str(root), transform=jtr.StandardTransform(
        32, 148), cache_transformed=True)


def test_port_file_matches_jax_file(tmp_path, sizes, jax_native):
    """Each package builds the cache of its own copy of the stand-in: the
    same file name, an npy of the same shape and dtype (rows within one
    level), a ``.src.json`` of the same keys and row count, each folder's
    fingerprint the same by either package's function; no temporary file
    is left."""
    folders = {k: _dsprites(tmp_path / k) for k in ("jax", "port")}
    j, t = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert t.cache_built and t.cache_file == str(folders["port"] / CACHE)
    for folder in folders.values():
        assert sorted(os.listdir(folder)) == [NPZ, CACHE,
                                              CACHE + ".src.json"]
    got, want = (np.load(folders[k] / CACHE) for k in ("port", "jax"))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_allclose(got.astype(int), want.astype(int), atol=1)
    np.testing.assert_array_equal(got, t._cache)
    metas = {k: json.loads((folders[k] / (CACHE + ".src.json")).read_text())
             for k in folders}
    assert metas["port"].keys() == metas["jax"].keys() == {"fingerprint", "n"}
    assert metas["port"]["n"] == metas["jax"]["n"] == len(j) == len(t)
    for k, folder in folders.items():
        assert metas[k]["fingerprint"] == tdd._source_fingerprint(
            str(folder)) == jdd._source_fingerprint(str(folder))


def test_port_reads_jax_cache(tmp_path, sizes, jax_native, monkeypatch):
    """A cache written by JAX is mapped by the port, which transforms
    nothing: its rows and batches are JAX's, bit for bit."""
    _dsprites(tmp_path)
    j = _jax(tmp_path)
    monkeypatch.setattr(ttr.StandardTransform, "batch", _no_transform)
    t = _port(tmp_path)
    assert not t.cache_built and isinstance(t._cache, np.memmap)
    np.testing.assert_array_equal(t._cache, j._cache)
    idxs = np.arange(len(t))[::-1]
    (ti, tf), (ji, jf) = t.get_batch(idxs), j.get_batch(idxs)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(ti, ji)


def _no_transform(self, imgs):
    raise AssertionError("the transform ran")


def test_reopen_maps_the_file(tmp_path, sizes, monkeypatch):
    """A second open of the same split maps the file the first wrote
    (``mmap_mode="r"``) and runs no transform: the same rows, byte for
    byte, and the same batches."""
    _dsprites(tmp_path)
    first = _port(tmp_path)
    assert first.cache_built and isinstance(first._cache, np.ndarray)
    monkeypatch.setattr(ttr.StandardTransform, "batch", _no_transform)
    again = _port(tmp_path)
    assert not again.cache_built and isinstance(again._cache, np.memmap)
    assert again._cache.tobytes() == first._cache.tobytes()
    idxs = np.arange(len(again))[::3]
    for a, b in zip(again.get_batch(idxs), first.get_batch(idxs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stale", ["rows", "swap"])
def test_stale_cache_is_rebuilt(tmp_path, sizes, stale):
    """A cache whose row count is not the split's (its ``.src.json`` left
    as it was), or one of a dataset file since swapped for other content
    of the same length (so only the fingerprint tells), is transformed
    again, and the new file holds the rows of the folder as it is now."""
    folder = _dsprites(tmp_path)
    first = _port(tmp_path)
    if stale == "rows":
        np.save(folder / CACHE, np.asarray(first._cache)[:-1])
    else:
        st = os.stat(folder / NPZ)
        _dsprites(tmp_path, seed=1)
        assert os.stat(folder / NPZ).st_size == st.st_size
        os.utime(folder / NPZ, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    again = _port(tmp_path)
    assert again.cache_built and len(again._cache) == len(again)
    fresh = tdd.load_dsprites(str(tmp_path), transform=ttr.StandardTransform(
        32, 148))
    want = np.clip(fresh.get_batch(np.arange(len(fresh)))[0] * 255.0 + 0.5,
                   0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.load(folder / CACHE), want)
    assert (not np.array_equal(want, first._cache)) == (stale == "swap")
    meta = json.loads((folder / (CACHE + ".src.json")).read_text())
    assert meta == {"fingerprint": tdd._source_fingerprint(str(folder)),
                    "n": len(again)}


def test_no_folder_keeps_the_cache_in_memory(tmp_path, jax_native):
    """An ``ArrayFactorDataset`` whose folder is not on disk has no cache
    file, in the port as in JAX (``_cache_path`` None): the rows are
    transformed in memory (within one level of JAX's) and nothing is
    written."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (6, 64, 64, 3)).astype(np.uint8)
    factors = np.indices((2, 3)).reshape(2, -1).T
    for root in ("", str(tmp_path / "absent")):
        args = (imgs, factors, (2, 3), root, "standin", "train")
        t = tdd.ArrayFactorDataset(*args, ttr.StandardTransform(32, 148),
                                   cache_transformed=True)
        j = jdd.ArrayFactorDataset(*args, jtr.StandardTransform(32, 148),
                                   cache_transformed=True)
        assert t._cache_path() is None and j._cache_path() is None
        assert t.cache_built and t.cache_file is None
        np.testing.assert_allclose(t._cache.astype(int),
                                   np.asarray(j._cache).astype(int), atol=1)
    assert os.listdir(tmp_path) == []
