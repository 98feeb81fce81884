"""The JPEG datasets and ConditionalVAE of the port against the JAX package.

The data: the port's libjpeg codec (``ctvae_torch/native``) with the
port's transform against ``ctvae_tpu.native.load_jpeg_batch`` (the same
libjpeg; the resize sums in another order: within 1e-6); ``MyCelebA`` and
``TCeleba`` (through ``VAEDataset``, batch for batch) against JAX's on a
fixture of 218 x 178 JPEGs written with PIL (one of them grey) with
attribute and partition files; the CelebA transition generator's bytes
against ``scripts/celeba_variation_gen.py``'s; OxfordPets' split and
images against JAX's PIL path (within 2 / 255, the JAX package's own
bound for PIL against its native path), and its refusal of PNG files;
the CelebA stand-in against ``scripts/make_celeba_standin.py`` (the same
names, partition and JPEG bytes: libjpeg and PIL encode alike); files
that are missing or do not decode raise with their names; the committed
libjpeg reference that the card's nvJPEG decode is held against.

The model: ConditionalVAE (alias ``CVAE``) at img 16, hidden [8, 16],
latent 8, 40 labels, B = 4, JAX weights converted by ``from_jax_params``:
the forward and loss at ``M_N`` 0.5, a train step with labels against
JAX's ``make_train_step`` (gradients within 1e-5 of their block's
largest, as tests/test_torch_zoo.py holds the zoo), the eval step,
``encode_labeled``, ``sample`` with labels on the same draws, the serving
entry points with labels against ``ctvae_tpu.serving.export``, the
registry's fields, the multi-step step against single steps, and
``run.train`` of ``configs/cvae.yaml`` from its YAML on the fixture.

    PYTHONPATH=. python tests/test_torch_celeba.py --write-reference

rewrites ``tests/torch_jpeg_reference.npz`` (what
``test_jpeg_reference_is_libjpegs`` checks).
"""

import copy
import filecmp
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch import native
from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (ReplayDraws, _jax_native_lib, close,
                               jax_native, jax_train_step_state,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "torch_jpeg_reference.npz")
H, W = 218, 178
IMG_ATOL = 1e-6          # the same decode, the resize summed apart
PIL_ATOL = 2.0 / 255.0 + 1e-6
N_FIXTURE = 48           # 32 train, 8 valid, 8 test; image 5 grey


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_celeba(root, n=N_FIXTURE, splits=(32, 8), attrs=True, seed=0):
    """A CelebA folder of ``n`` 218 x 178 JPEGs written by PIL (noise at
    quality 90; image 5 grey), its partition (``splits`` train / valid,
    the rest test) and, with ``attrs``, its attributes: +-1 draws, each
    odd image a copy of the one before with attribute 0 flipped
    (tests/test_dataset_tools.py's fixture)."""
    from PIL import Image
    folder = os.path.join(root, "celeba")
    img_dir = os.path.join(folder, "img_align_celeba")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"{i:06d}.jpg" for i in range(1, n + 1)]
    values = rng.choice([-1, 1], size=(n, 40))
    values[1::2] = values[0:n - 1:2]
    values[1::2, 0] = -values[1::2, 0]
    for i, name in enumerate(names):
        arr = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
        img = Image.fromarray(arr)
        (img.convert("L") if i == 5 else img).save(
            os.path.join(img_dir, name), quality=90)
    if attrs:
        with open(os.path.join(folder, "list_attr_celeba.txt"), "w") as f:
            f.write(f"{n}\n" + " ".join(f"A{j}" for j in range(40)) + "\n")
            for name, row in zip(names, values):
                f.write(name + " " + " ".join(str(v) for v in row) + "\n")
    with open(os.path.join(folder, "list_eval_partition.txt"), "w") as f:
        for i, name in enumerate(names):
            split = 0 if i < splits[0] else 1 if i < sum(splits) else 2
            f.write(f"{name} {split}\n")
    return folder


@pytest.fixture(scope="module")
def celeba_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("celeba"))
    _write_celeba(root)
    _script("celeba_variation_gen").generate(root)
    return root


def _paths(root, names):
    return [os.path.join(root, "celeba", "img_align_celeba", n)
            for n in names]


# --- the codec and the transform ----------------------------------------------

@pytest.mark.parametrize("patch", [64, 32])
def test_decode_and_transform_match_jax_native(celeba_root, jax_native,
                                               patch):
    """The port's decode + ``StandardTransform(patch, 148).batch`` against
    the JAX package's fused libjpeg decode + crop + resize, a grey file
    among them; the decode alone against PIL's."""
    from PIL import Image

    from ctvae_torch.data.transforms import StandardTransform
    from ctvae_tpu import native as jnative
    assert jnative.available()
    paths = _paths(celeba_root, [f"{i:06d}.jpg" for i in range(1, 13)])
    raw = native.codec("libjpeg").decode_batch(paths)
    assert raw.shape == (12, H, W, 3) and raw.dtype == np.uint8
    assert np.array_equal(raw[5, ..., 0], raw[5, ..., 2])   # the grey one
    pil = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    assert np.array_equal(raw, pil)
    got = StandardTransform(patch, crop=148).batch(raw)
    want = jnative.load_jpeg_batch(paths, 148, patch)
    close(got, want, atol=IMG_ATOL, rtol=0)


def test_codec_sizes_encode_and_single_decode(tmp_path):
    """``size`` reads the header, ``decode`` takes any size, and
    ``encode_batch`` at quality 80 writes the bytes PIL's ``save(quality=
    80)`` writes."""
    from PIL import Image
    codec = native.codec("libjpeg")
    assert codec.version.startswith("libjpeg ")
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (2, 37, 51, 3)).astype(np.uint8)
    paths = [str(tmp_path / f"{i}.jpg") for i in range(2)]
    codec.encode_batch(images, paths, 80)
    for img, path in zip(images, paths):
        Image.fromarray(img).save(path + ".pil.jpg", quality=80)
        assert filecmp.cmp(path, path + ".pil.jpg", shallow=False)
        assert codec.size(path) == (37, 51)
        assert np.array_equal(codec.decode(path),
                              np.asarray(Image.open(path).convert("RGB")))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_unreadable_files_raise_with_their_names(tmp_path):
    """A missing file, a file that is no JPEG and a JPEG of another size
    in a batch each raise, naming the file; a batch decode fills no
    zeros in their place."""
    root = str(tmp_path)
    _write_celeba(root, n=8, splits=(8, 0))
    from ctvae_torch.data.celeba import MyCelebA
    ds = MyCelebA(root, split="train")
    paths = _paths(root, ds.filename)
    os.remove(paths[2])
    with pytest.raises(OSError, match="000003.jpg cannot be read"):
        ds.get_batch(np.arange(4))
    with open(paths[3], "wb") as f:
        f.write(b"not a jpeg at all")
    with pytest.raises(OSError, match="000004.jpg"):
        ds.get_batch([3])
    native.codec("libjpeg").encode_batch(
        np.zeros((1, 20, 30, 3), np.uint8), [paths[4]])
    with pytest.raises(OSError, match="000005.jpg is no JPEG of the "
                                      "batch's size"):
        ds.get_batch([0, 4])
    assert ds.get_batch([0, 1])[0].shape == (2, 64, 64, 3)


def test_jpeg_reference_is_libjpegs():
    """``tests/torch_jpeg_reference.npz`` (what the card's nvJPEG decode
    is held against): its JPEGs are the stand-in's images 1 and 2 encoded
    by the port's libjpeg at quality 80 and a grey one written by PIL,
    and its pixels libjpeg's decode of them."""
    want = reference_arrays()
    with np.load(REFERENCE) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k


# --- CelebA and TCeleba ---------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "valid", "test", "all"])
def test_celeba_matches_jax(celeba_root, jax_native, split):
    """The split's files, and ``get_batch`` (images and the 0 / 1 labels)
    and ``__getitem__`` against JAX's ``MyCelebA``."""
    from ctvae_torch.data.celeba import MyCelebA
    from ctvae_tpu.data.celeba import MyCelebA as JCelebA
    t, j = MyCelebA(celeba_root, split=split), JCelebA(celeba_root,
                                                       split=split)
    assert t.filename == j.filename and t.indices == j.indices
    assert t._full_data is t and (t.root, t.base_folder) == (j.root,
                                                            j.base_folder)
    idxs = np.random.default_rng(2).permutation(len(t))[:6]
    (gi, gl), (wi, wl) = t.get_batch(idxs), j.get_batch(idxs)
    close(gi, wi, atol=IMG_ATOL, rtol=0)
    assert gl.dtype == np.float32 and gl.shape == (len(idxs), 40)
    np.testing.assert_array_equal(gl, wl)
    assert set(np.unique(gl)) == {0.0, 1.0}
    img, label = t[int(idxs[0])]
    close(img, gi[0], atol=0, rtol=0)
    np.testing.assert_array_equal(label, gl[0])


def test_celeba_without_attributes_has_zero_labels(tmp_path):
    root = str(tmp_path)
    _write_celeba(root, n=6, splits=(6, 0), attrs=False)
    from ctvae_torch.data.celeba import MyCelebA
    from ctvae_tpu.data.celeba import MyCelebA as JCelebA
    got = MyCelebA(root).get_batch(np.arange(4))[1]
    want = JCelebA(root).get_batch(np.arange(4))[1]
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 40) and not got.any()


def test_celeba_variation_file_is_the_scripts_bytes(tmp_path, capsys):
    """``generate_celeba`` (``python -m ctvae_torch.data.variations
    celeba``) writes ``scripts/celeba_variation_gen.py``'s bytes, and the
    fixture has transitions of both directions."""
    from ctvae_torch.data.variations import main
    roots = [str(tmp_path / side) for side in ("port", "jax")]
    for root in roots:
        _write_celeba(root, n=24, splits=(16, 4))
    main(["celeba", roots[0]])
    _script("celeba_variation_gen").generate(roots[1])
    files = [os.path.join(r, "celeba", "variation_attrs_10.txt")
             for r in roots]
    assert filecmp.cmp(*files, shallow=False)
    with open(files[0]) as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) > 0 and {r.split(",")[4] for r in rows} == {"0", "1"}
    assert "transitions" in capsys.readouterr().out


def test_tceleba_datamodule_matches_jax(celeba_root, jax_native):
    """``VAEDataset(dataset_name="TCeleba")`` against JAX's: the
    transitions (20 actions), steps per epoch, and the train, val and
    test loaders of two epochs batch for batch and mode for mode."""
    from ctvae_torch.data import TransitionDataset, VAEDataset
    from ctvae_tpu.data.datamodule import VAEDataset as JVAEDataset
    args = dict(dataset_name="TCeleba", train_batch_size=4,
                val_batch_size=4, patch_size=16, limit=8, val_limit=8,
                seed=3, num_workers=4)
    jd = JVAEDataset(celeba_root, distributed=False, **args)
    td = VAEDataset(celeba_root, **args)
    jd.setup()
    td.setup()
    t, j = td.train_dataset, jd.train_dataset
    assert isinstance(t, TransitionDataset) and t.actions.shape[1] == 20
    assert t.transitions == [tuple(p) for p in j.transitions]
    np.testing.assert_array_equal(t.actions, j.actions)
    assert td.steps_per_epoch() == jd.steps_per_epoch() > 0
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        for epoch in (0, 1):
            want = list(getattr(jd, loader)(epoch))
            got = list(getattr(td, loader)(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys() and g["mode"] == w["mode"]
                for k in w:
                    if k in ("image", "input_y"):
                        close(g[k], w[k], atol=IMG_ATOL, rtol=0)
                    elif k != "mode":
                        np.testing.assert_array_equal(g[k], w[k])
    assert {b["mode"] for b in td.train_dataloader(0)} == {
        "base", "action", "causal"}


# --- OxfordPets -----------------------------------------------------------------

OXFORD_SIZES = [(150, 200), (300, 250), (120, 100), (64, 64), (160, 160),
                (200, 149), (90, 300), (148, 148)]


def _write_oxford(root, png=False):
    from PIL import Image
    folder = os.path.join(root, "OxfordPets", "images")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(OXFORD_SIZES):
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"pet_{i}.jpg"),
                                  quality=85)
    if png:
        Image.fromarray(arr).save(os.path.join(folder, "pet_9.png"))
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_oxford_pets_matches_jax(tmp_path, split):
    """The 75 / 25 split of the sorted files and each image (decoded and
    transformed alone: the sizes differ) against JAX's PIL path, labels
    0; ``get_batch`` stacks them; ``VAEDataset`` loads it."""
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.data.oxford import OxfordPets
    from ctvae_tpu.data.oxford import OxfordPets as JOxfordPets
    root = _write_oxford(str(tmp_path))
    t, j = OxfordPets(root, split=split), JOxfordPets(root, split=split)
    assert t.filename == j.filename and len(t) == (6 if split == "train"
                                                   else 2)
    for i in range(len(t)):
        (gi, gl), (wi, wl) = t[i], j[i]
        close(gi, wi, atol=PIL_ATOL, rtol=0)
        assert gl == wl == 0.0
    imgs, labels = t.get_batch(np.arange(len(t)))
    close(imgs, np.stack([t[i][0] for i in range(len(t))]), atol=0, rtol=0)
    assert labels.shape == (len(t),) and not labels.any()
    data = VAEDataset(root, dataset_name="OxfordPets", train_batch_size=2,
                      val_batch_size=2, patch_size=64)
    data.setup()
    batches = list(data.train_dataloader(0))
    assert len(batches) == 3 and batches[0]["image"].shape == (2, 64, 64, 3)


def test_oxford_pets_png_raises(tmp_path):
    """The port lists and reads a ``.png`` as the JAX package does (PIL),
    the same pixels; a ``.png`` whose bytes are no image raises naming
    it, as PIL does."""
    from ctvae_torch.data.oxford import OxfordPets
    from ctvae_tpu.data.oxford import OxfordPets as JOxfordPets
    root = _write_oxford(str(tmp_path), png=True)
    t, j = OxfordPets(root, split="test"), JOxfordPets(root, split="test")
    assert "pet_9.png" in t.filename and t.filename == j.filename
    i = t.filename.index("pet_9.png")
    close(t[i][0], j[i][0], atol=PIL_ATOL, rtol=0)
    with open(os.path.join(root, "OxfordPets", "images", "pet_9.png"),
              "wb") as f:
        f.write(b"not an image")
    with pytest.raises(ValueError, match="pet_9.png"):
        t[i]


# --- the stand-in ---------------------------------------------------------------

def test_celeba_standin_matches_the_script(tmp_path, capsys):
    """``python -m ctvae_torch.data.standins celeba --count 24`` against
    ``scripts/make_celeba_standin.py`` at 24: the same file names,
    partition bytes and JPEG bytes; a second run writes nothing;
    ``label_celeba_standin`` splits 80 / 10 / 10 and writes attributes
    that ``MyCelebA`` reads."""
    from ctvae_torch.data.celeba import MyCelebA
    from ctvae_torch.data.standins import label_celeba_standin, main
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    main(["celeba", "--root", port, "--count", "24"])
    _script("make_celeba_standin").ensure_celeba_standin(ref, 24,
                                                         verbose=False)
    folders = [os.path.join(r, "celeba") for r in (port, ref)]
    names = [sorted(os.listdir(os.path.join(f, "img_align_celeba")))
             for f in folders]
    assert names[0] == names[1] and len(names[0]) == 24
    assert filecmp.cmp(*[os.path.join(f, "list_eval_partition.txt")
                         for f in folders], shallow=False)
    for name in names[0]:
        assert filecmp.cmp(*[os.path.join(f, "img_align_celeba", name)
                             for f in folders], shallow=False), name
    main(["celeba", "--root", port, "--count", "24"])
    assert "(0 new" in capsys.readouterr().out.splitlines()[-1]
    assert label_celeba_standin(port, 24) == {"train": 19, "valid": 2,
                                              "test": 3}
    ds = MyCelebA(port, split="test")
    labels = ds.get_batch(np.arange(3))[1]
    assert ds.filename == ["000022.jpg", "000023.jpg", "000024.jpg"]
    # images 23 and 24 are a pair: attribute 0 flipped, the rest equal
    assert labels.shape == (3, 40) and labels[1, 0] != labels[2, 0]
    np.testing.assert_array_equal(labels[1, 1:], labels[2, 1:])


# --- the libjpeg reference of the card's decode ----------------------------------

def reference_arrays() -> dict:
    """The stand-in's images 1 and 2 encoded by the port's libjpeg at
    quality 80 and a grey image written by PIL (quality 80), each as its
    JPEG bytes and libjpeg's decode."""
    import tempfile

    from PIL import Image

    from ctvae_torch.data.standins import render_celeba_images
    codec = native.codec("libjpeg")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.jpg") for i in (1, 2, 3)]
        images = render_celeba_images([1, 2, 3])
        codec.encode_batch(images[:2], paths[:2], 80)
        Image.fromarray(images[2].mean(-1).astype(np.uint8)).save(
            paths[2], quality=80)
        for name, path in zip(("color_1", "color_2", "grey_3"), paths):
            with open(path, "rb") as f:
                out[f"jpeg_{name}"] = np.frombuffer(f.read(), np.uint8)
            out[f"decoded_{name}"] = codec.decode(path)
    return out


# --- ConditionalVAE ---------------------------------------------------------------

B, IMG = 4, 16
CVAE = dict(name="ConditionalVAE", in_channels=3, num_classes=40,
            latent_dim=8, hidden_dims=[8, 16], img_size=IMG)
EXP = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
M_N = 0.5
LOSS_RTOL = 1e-4
_PAIR = {}


def _inputs(seed: int, n: int = B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, IMG, IMG, 3)).astype(np.float32),
            rng.integers(0, 2, (n, 40)).astype(np.float32))


def _pair():
    """(JAX model, variables, the port's model with them), built once."""
    from ctvae_torch.models import build_model
    from ctvae_tpu.models import build_model as jax_build
    if not _PAIR:
        jm = jax_build(dict(CVAE))
        x, y = _inputs(0, 2)
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        variables = jax.device_get(jax.jit(
            lambda r, x, y: jm.init(r, x, y, train=False))(
            dict(zip(("params", "reparam"), keys)), jnp.asarray(x),
            jnp.asarray(y)))
        tm = build_model(dict(CVAE), device="cpu")
        tm.load_state_dict(from_jax_params(variables, tm))
        _PAIR["pair"] = (jm, variables, tm)
    jm, variables, tm = _PAIR["pair"]
    return jm, variables, copy.deepcopy(tm)


def _close_scaled(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    close(got, want, atol=rel * max(float(np.abs(want).max()), 1e-30),
          rtol=0)


def test_cvae_forward_and_loss_match_jax():
    """The eval forward (running statistics, z = mu) with labels and
    ``loss_function`` at ``M_N`` 0.5."""
    jm, variables, tm = _pair()
    x, y = _inputs(21)
    j_out = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), train=False)
    j_loss = jm.loss_function(j_out, M_N=M_N)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(y), train=False)
        loss = tm.loss_function(out, M_N=M_N, step=torch.tensor(0),
                                train=False, optimizer_idx=0)
    for k in ("recons", "mu", "log_var", "z"):
        _close_scaled(t2n(out[k]), j_out[k])
    assert set(loss) == set(j_loss)
    for k, v in j_loss.items():
        close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="labels"):
        tm(torch.from_numpy(x))


def _block(name: str) -> str:
    return name.rsplit(".", 2)[0]


def test_cvae_train_step_matches_jax(monkeypatch):
    """One train step with the batch's labels at ``M_N`` 0.5 against
    JAX's ``make_train_step`` (forward keys ``labels``): metrics,
    ``grad_norm``, every gradient within 1e-5 of its block's largest,
    every parameter after Adam, BatchNorm's running statistics."""
    jm, variables, tm = _pair()
    x, y = _inputs(11)
    b = {"image": x, "labels": y}
    j_params, j_grads, j_metrics, draws, j_state = jax_train_step_state(
        jm, variables, "base", {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=12, exp=EXP, M_N=M_N, fwd_kwargs_keys=("labels",))
    assert [k for k, _ in draws] == ["normal"]      # the reparameterisation
    replay = ReplayDraws(draws)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    with monkeypatch.context() as m:
        m.setattr(tstate, "Draws", lambda gen, device: replay)
        metrics = tstate.make_train_step("base", M_N=M_N)(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert replay.done()
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    scale = {}
    for name, g in want_g.items():
        scale[_block(name)] = max(scale.get(_block(name), 1.0),
                                  float(g.abs().max()))
    assert float(want_g["embed_class.weight"].abs().max()) > 0
    for name, p in tm.named_parameters():
        close(t2n(p.grad), want_g[name].numpy(),
              atol=1e-5 * scale[_block(name)], rtol=0)
        tol = 2e-6 + EXP["LR"] / 1e-8 * (p.grad - want_g[name]).abs()
        assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), name
    want = from_jax_params({"params": j_params, **j_state}, tm)
    for n, t in tm.named_buffers():
        close(t2n(t), want[n].numpy(), atol=1e-5, rtol=1e-4)


def test_cvae_eval_step_matches_jax():
    """The eval step (``M_N`` 1.0, z = mu) with labels against JAX's
    ``make_eval_step``; no buffer written."""
    from ctvae_tpu.training import state as jstate
    jm, variables, tm = _pair()
    j_state = jstate.TrainState(
        step=jnp.array(0, jnp.int32), params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=(), rng=jax.random.PRNGKey(2))
    x, y = _inputs(31)
    want = jax.device_get(jax.jit(jstate.make_eval_step(jm, M_N=1.0))(
        j_state, {"image": jnp.asarray(x), "labels": jnp.asarray(y)}))
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    before = {n: t.clone() for n, t in tm.named_buffers()}
    got = tstate.make_eval_step("base")(
        state, {"image": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert set(got) == set(want)
    for k, v in want.items():
        close(t2n(got[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    for n, t in tm.named_buffers():
        assert torch.equal(t, before[n]), n


def test_cvae_encode_labeled_and_sample_match_jax(monkeypatch):
    """``encode_labeled`` (raw image and labels) and ``sample(n, labels)``
    from the same prior draws."""
    jm, variables, tm = _pair()
    x, y = _inputs(41)
    j_mu, j_lv = jm.apply(variables, jnp.asarray(x), jnp.asarray(y),
                          method=jm.encode_labeled)
    with recorded_draws(monkeypatch, seed=6) as rec:
        j_s = jm.apply(variables, 3, jnp.asarray(y), rngs={
            "reparam": jax.random.PRNGKey(0)}, method=jm.sample)
    with torch.no_grad():
        mu, lv = tm.encode_labeled(torch.from_numpy(x), torch.from_numpy(y))
        replay = ReplayDraws(rec.draws)
        s = tm.sample(3, torch.from_numpy(y), draws=replay)
    assert replay.done() and s.shape == (3, IMG, IMG, 3)
    _close_scaled(t2n(mu), j_mu)
    _close_scaled(t2n(lv), j_lv)
    _close_scaled(t2n(s), j_s)


def test_cvae_serving_takes_labels_as_jax_does(monkeypatch):
    """``reconstruct(x, labels)``, ``encode(x, labels)`` and
    ``sample(labels)`` against ``ctvae_tpu.serving.export``'s entry points
    of a labelled model (the prior's draws replayed)."""
    from ctvae_torch.serving import inference
    from ctvae_tpu.serving import export
    jm, variables, tm = _pair()
    x, y = _inputs(51)
    key = jax.random.PRNGKey(0)
    assert inference.available_fns(tm) == ("reconstruct", "encode",
                                           "sample")
    for name, j_args, t_args in (
            ("reconstruct", (x, y), (x, y)), ("encode", (x, y), (x, y)),
            ("sample", (y,), (y,))):
        with recorded_draws(monkeypatch, seed=8) as rec:
            want = export.make_inference_fn(jm, variables, name,
                                            num_samples=B)(
                key, *map(jnp.asarray, j_args))
        replay = ReplayDraws(rec.draws)
        with monkeypatch.context() as m:
            m.setattr(inference, "_draws", lambda model, gen: replay)
            got = inference.make_inference_fn(tm, name, num_samples=B)(
                *map(torch.from_numpy, t_args))
        assert replay.done(), name
        _close_scaled(t2n(got), want)


def test_cvae_registry_fields_and_alias():
    """``ConditionalVAE`` and its alias ``CVAE`` name the JAX registry's
    class; the port takes every field of its dataclass; flax's init
    spread on the new layers."""
    from ctvae_torch.models import build_model, model_fields, vae_models
    from ctvae_tpu.models import vae_models as jax_models
    for name in ("ConditionalVAE", "CVAE"):
        assert vae_models[name].__name__ == jax_models[name].__name__
        want = set(jax_models[name].__dataclass_fields__) - {"parent",
                                                             "name"}
        assert model_fields(vae_models[name]) == want
    tm = build_model({"name": "CVAE", "kld_weight": 0.1}, device="cpu")
    assert type(tm) is vae_models["ConditionalVAE"] and tm.needs_labels
    for p, fan_in in ((tm.embed_class.weight, 40),
                      (tm.decoder_input.weight, 128 + 40)):
        assert abs(float(p.detach().std()) * math.sqrt(fan_in) - 1.0) < 0.1
    assert not tm.embed_class.bias.any() and tm.encoder.ConvBNBlock_0.\
        Conv_0.weight.shape[1] == 4


def test_cvae_multi_train_step_equals_steps():
    """``make_multi_train_step("base", 2)`` twice equals four single
    steps on labelled batches: parameters, buffers, Adam, generator and
    step bit for bit."""
    _, _, tm = _pair()
    states = [tstate.create_train_state(
        m, topt.build_optimizers(EXP, m, 4), seed=3)
        for m in (copy.deepcopy(tm), copy.deepcopy(tm))]
    batches = [{k: torch.from_numpy(v) for k, v in zip(
        ("image", "labels"), _inputs(60 + i))} for i in range(4)]
    losses = [float(tstate.make_train_step("base", M_N=M_N)(
        states[0], b)["loss"]) for b in batches]
    multi = tstate.make_multi_train_step("base", 2, M_N=M_N)
    for half in (batches[:2], batches[2:]):
        last = multi(states[1], {k: torch.stack([b[k] for b in half])
                                 for k in half[0]})
    assert float(last["loss"]) == losses[-1]
    a, b = (s.state_dict() for s in states)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    for n, t in a["model"].items():
        assert torch.equal(t, b["model"][n]), n


def test_run_train_cvae_yaml_on_celeba(tmp_path, monkeypatch):
    """``python -m ctvae_torch.run -c configs/cvae.yaml`` with PyYAML
    unimportable, the YAML as written (``dataset_name: Celeba``, B = 64,
    full width) but for ``data_path``, one epoch and the log directory:
    on 136 fixture images (64 train, 64 test), finite metrics, the
    labels reach the train and eval steps, checkpoints and the three
    grids (the Samples grid decoded beside the test batch's labels)."""
    import yaml

    from ctvae_torch import run
    from ctvae_torch.config import read_config
    from ctvae_torch.models import ConditionalVAE
    root = str(tmp_path / "Data")
    _write_celeba(root, n=136, splits=(64, 8))
    cfg = read_config(os.path.join(REPO, "configs", "cvae.yaml"))
    assert cfg["data_params"]["dataset_name"] == "Celeba"
    cfg["data_params"]["data_path"] = root
    cfg["trainer_params"]["max_epochs"] = 1
    cfg["logging_params"]["save_dir"] = str(tmp_path / "logs")
    path = tmp_path / "cvae.yaml"
    path.write_text(yaml.safe_dump(cfg))
    seen = []
    orig = ConditionalVAE.forward

    def spy(self, x, labels=None, **kwargs):
        seen.append((kwargs.get("train"), tuple(labels.shape)))
        return orig(self, x, labels, **kwargs)

    monkeypatch.setattr(ConditionalVAE, "forward", spy)
    monkeypatch.setitem(sys.modules, "yaml", None)
    out = run.main(["-c", str(path), "--device", "cpu"])
    assert all(math.isfinite(v) for v in out.values())
    assert out["train_steps_base"] == 1.0 and "val_loss" in out
    assert (True, (64, 40)) in seen and (False, (64, 40)) in seen
    run_dir = os.path.join(str(tmp_path / "logs"), "ConditionalVAE",
                           "version_0")
    assert "last" in os.listdir(os.path.join(run_dir, "checkpoints"))
    for sub in ("Inputs", "Reconstructions", "Samples"):
        assert len(os.listdir(os.path.join(run_dir, sub))) == 1, sub


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-reference"]:
        sys.exit(__doc__)
    np.savez_compressed(REFERENCE, **reference_arrays())
    print(f"=> {REFERENCE} ({os.path.getsize(REFERENCE)} bytes)")
