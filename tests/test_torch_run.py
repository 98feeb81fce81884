"""The port's training entry point and the loop's services on the CPU:
``config.read_config`` against PyYAML, ``ExperimentLogger`` against the
JAX logger's JSONL writer, ``run.train`` / ``run.main`` on a Shapes3D
stand-in (checkpoints, ``scalars.jsonl``, ``hparams.json``, the image
grids), ``apply_action`` on that run's checkpoint and against the JAX
tool's names and input, and a SIGTERM mid-``fit``.

Comparisons are exact (config dicts, JSONL lines, file names, states)
except the rendered input image, within one level of 255 (the two
transforms differ by ~1e-7, see tests/test_torch_data.py).
"""

import glob
import importlib.util
import json
import os
import signal
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import MCQ, SMALL, one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (2, 2, 3, 4, 2, 3)          # 288 images of the Shapes3D stand-in
CT12 = dict(SMALL, action_dim=12)  # Shapes3D's six factors: 12 actions
MODES = ("base", "action", "causal")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _png_pixels(path) -> np.ndarray:
    """The pixels of a PNG the port writes (8-bit, unfiltered rows)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    return rows.reshape(h, 1 + w * c)[:, 1:].reshape(h, w, c)


# --- the config reader -------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yaml"))), ids=os.path.basename)
def test_read_config_matches_yaml(path):
    from ctvae_torch.config import read_config
    with open(path) as f:
        assert read_config(path) == yaml.safe_load(f)


def test_read_config_reads_safe_dump_and_refuses_the_rest(tmp_path):
    """What ``yaml.safe_dump`` writes of a config (block lists, quoted
    strings, nulls, nested mappings) reads back equal; a top-level
    scalar, an anchor and a list of mappings raise."""
    from ctvae_torch.config import read_config
    cfg = {"model_params": dict(CT12, hidden_dims=[8, 16], noise="off"),
           "data_params": {"data_path": "", "limit": None,
                           "patch_size": [16, 16]},
           "trainer_params": {"max_epochs": 1, "load_weights_only": True}}
    path = tmp_path / "dumped.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert "- 8" in path.read_text()
    assert read_config(str(path)) == cfg
    path.write_text("a:\n  b:\n    c: 1\n")
    assert read_config(str(path)) == {"a": {"b": {"c": 1}}}
    for text in ("seed: 3\n", "a:\n  b: &x 1\n",
                 "a:\n  b:\n  - c: 1\n"):
        path.write_text(text)
        with pytest.raises(ValueError):
            read_config(str(path))


def test_entry_points_import_no_yaml():
    for name in ("run.py", "apply_action.py"):
        with open(os.path.join(REPO, "ctvae_torch", name)) as f:
            assert "import yaml" not in f.read(), name


# --- the logger --------------------------------------------------------------

def test_logger_writes_the_jax_lines(tmp_path, monkeypatch):
    """The same values through the JAX logger (its JSONL writer, as on a
    host without TensorBoard) and the port's: equal ``scalars.jsonl`` and
    ``hparams.json``, version directories numbered alike, the 2-D array
    as an image of the same pixels (JAX: ``.npy``, the port: ``.png``)."""
    from ctvae_tpu.utils import logging as jlog
    from ctvae_torch.utils.images import to_uint8
    from ctvae_torch.utils.logging import ExperimentLogger
    monkeypatch.setattr(jlog, "_make_summary_writer", jlog._JsonlWriter)
    hparams = {"model_params": CT12, "exp_params": {"LR": np.float32(5e-4)}}
    adjacency = np.random.default_rng(0).random((6, 6)).astype(np.float32)
    values = {"loss": np.float32(1.25), "Reconstruction_Loss": 0.0625,
              "steps": np.int64(3), "mode": "causal", "ct_mask": np.ones(6),
              "ct_adjacency": adjacency}
    loggers = {}
    for side, cls in (("jax", jlog.ExperimentLogger),
                      ("torch", ExperimentLogger)):
        for version in (0, 1):
            lg = cls(str(tmp_path / side), "CT", hparams=hparams)
            assert lg.version == version
        lg.log_all(values, 7)
        lg.log_all({"val_loss": 0.5}, 9, prefix="x/")
        (lg.tb if side == "jax" else lg).add_scalar("epoch", 0, 9)
        lg.finish()
        loggers[side] = lg
    jdir, tdir = loggers["jax"].log_dir, loggers["torch"].log_dir
    assert os.path.relpath(jdir, tmp_path / "jax") == \
        os.path.relpath(tdir, tmp_path / "torch") == os.path.join("CT",
                                                                  "version_1")
    for name in ("scalars.jsonl", "hparams.json"):
        with open(os.path.join(jdir, name)) as a, \
                open(os.path.join(tdir, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(tdir, "scalars.jsonl")) as f:
        assert [json.loads(ln) for ln in f] == [
            {"step": 7, "loss": 1.25}, {"step": 7, "Reconstruction_Loss":
                                        0.0625},
            {"step": 7, "steps": 3.0}, {"step": 9, "x/val_loss": 0.5},
            {"step": 9, "epoch": 0.0}]
    want = np.load(os.path.join(jdir, "ct_adjacency_7.npy"))
    np.testing.assert_array_equal(
        _png_pixels(os.path.join(tdir, "ct_adjacency_7.png")),
        to_uint8(want))
    assert sorted(os.listdir(tdir)) == ["ct_adjacency_7.png", "hparams.json",
                                        "scalars.jsonl"]


# --- run.train and apply_action on a Shapes3D stand-in -----------------------

@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    from ctvae_torch.data.standins import write_shapes3d_standin
    root = tmp_path_factory.mktemp("shapes3d")
    write_shapes3d_standin(str(root), GRID)
    return str(root)


def _config(root, logs, model, dataset, **data):
    return {"model_params": dict(model),
            "data_params": {"data_path": root, "dataset_name": dataset,
                            "train_batch_size": 8, "val_batch_size": 8,
                            "patch_size": 16, "num_workers": 4, **data},
            "exp_params": {"LR": 0.001, "manual_seed": 7,
                           **({"update_parameters": "ct_layer"}
                              if model["name"] == "CTMCQVAE" else {})},
            "trainer_params": {"max_epochs": 1},
            "logging_params": {"save_dir": logs, "name": model["name"]}}


@pytest.mark.parametrize("model,dataset", [(MCQ, "Shapes3D"),
                                           (CT12, "TShapes3D")],
                         ids=["MCQVAE", "CTMCQVAE"])
def test_run_trains_on_shapes3d_standin(tmp_path, monkeypatch, shapes_root,
                                        model, dataset):
    """``python -m ctvae_torch.run -c <yaml> --device cpu`` with PyYAML
    unimportable: one epoch on the stand-in, finite metrics, and under
    ``version_0`` the checkpoints, ``hparams.json`` (the config),
    ``scalars.jsonl`` (validation, epoch, images per second) and valid
    ``Inputs`` / ``Reconstructions`` / ``Samples`` grids; for the CT
    model every mode ran and ``apply_action`` runs on its checkpoint."""
    from ctvae_torch import apply_action, run
    logs = str(tmp_path / "logs")
    cfg = _config(shapes_root, logs, model, dataset, limit=16, val_limit=16)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setitem(sys.modules, "yaml", None)      # not importable
    out = run.main(["-c", str(path), "--device", "cpu"])
    assert all(np.isfinite(v) for v in out.values())
    assert "val_Reconstruction_Loss" in out
    if dataset == "TShapes3D":
        assert all(out[f"train_steps_{m}"] == 2.0 for m in MODES)
    name = model["name"]
    run_dir = os.path.join(logs, name, "version_0")
    steps = int(sum(out.get(f"train_steps_{m}", 0) for m in MODES))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "index.json", "last", f"step_{steps}"]
    with open(os.path.join(run_dir, "hparams.json")) as f:
        assert json.load(f) == cfg
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        keys = {k for ln in f for k in json.loads(ln) if k != "step"}
    assert {"val_loss", "epoch", "images_per_sec"} <= keys
    smoke = _smoke()
    for sub, fname in (("Inputs", f"real_img_{name}_Epoch_0.png"),
                       ("Reconstructions", f"recons_{name}_Epoch_0.png"),
                       ("Samples", f"{name}_Epoch_0.png")):
        png = os.path.join(run_dir, sub, fname)
        assert smoke._valid_png(png), png
    assert _png_pixels(os.path.join(run_dir, "Samples",
                                    f"{name}_Epoch_0.png")).shape[:2] == (
        2 + 3 * 18, 2 + 12 * 18)       # 32 samples of 16 x 16, 12 a row
    if dataset == "TShapes3D":
        res = apply_action.main(["-c", str(path), "--ckpt", os.path.join(
            run_dir, "checkpoints", "last"), "--out", str(tmp_path / "img"),
            "--steps", "1", "--device", "cpu"])
        assert len(res["images"]) == 1 + 12
        assert all(smoke._valid_png(p) for p in res["images"])
        assert res["causal_batches"] > 0 and np.isfinite(res["causal_acc"])


def test_apply_action_matches_the_jax_tool(tmp_path):
    """On TShapes3D the port's tool writes the JAX tool's files (its
    ``ACTION_NAMES``, ``images/<dataset>_<id>/CT-VAE_*`` names) and its
    input image is the JAX data module's first action batch's."""
    pytest.importorskip("h5py")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    from apply_action import ACTION_NAMES as JAX_ACTION_NAMES
    from make_shapes3d_standin import ensure_shapes3d_standin

    from ctvae_tpu.data.datamodule import VAEDataset as JVAEDataset
    from ctvae_torch.apply_action import ACTION_NAMES, apply_action
    from ctvae_torch.data.standins import shapes3d_h5_to_npz
    from ctvae_torch.data.variations import generate
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state
    from ctvae_torch.utils.checkpoint import CheckpointManager
    from ctvae_torch.utils.images import make_grid, to_uint8
    root = str(tmp_path / "data")
    ensure_shapes3d_standin(root, factor_sizes=GRID, verbose=False)
    shapes3d_h5_to_npz(root)
    generate("3dshapes", root, factor_sizes=GRID)
    assert ACTION_NAMES == JAX_ACTION_NAMES
    cfg = _config(root, str(tmp_path / "logs"), CT12, "TShapes3D", limit=16)
    model = build_model(CT12, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    cm.save(create_train_state(model, build_optimizers({}, model), 0), 0)
    res = apply_action(cfg, cm.path("last"), out=str(tmp_path / "images"),
                       run_id="t", steps=2, device="cpu")
    names = JAX_ACTION_NAMES["TShapes3D"]
    want = ["CT-VAE_input_TShapes3D.png"] + [
        f"CT-VAE_output_TShapes3D_{a}_{sign}{step}.png" for step in range(2)
        for sign in "+-" for a in names]
    assert [os.path.basename(p) for p in res["images"]] == want
    assert res["out_dir"] == str(tmp_path / "images" / "TShapes3D_t")
    jd = JVAEDataset(root, distributed=False,
                     **{k: v for k, v in cfg["data_params"].items()
                        if k != "data_path"})
    jd.setup()
    jbatch = next(b for b in jd.test_dataloader(0) if b["mode"] == "action")
    got = _png_pixels(res["images"][0]).astype(int)
    expect = to_uint8(make_grid(jbatch["image"][:1], normalize=True))
    np.testing.assert_allclose(got, expect.astype(int), atol=1)


# --- preemption --------------------------------------------------------------

def _experiment(tmp, seed, ckpt=True):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    data = VAEDataset("", dataset_name="TSynthetic", train_batch_size=8,
                      val_batch_size=8, patch_size=16, limit=24,
                      val_limit=8, seed=5)
    data.setup()
    model = build_model(dict(SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return VAEXperiment(model, {"LR": 0.001}, data,
                        ckpt_manager=CheckpointManager(str(tmp)) if ckpt
                        else None)


def test_sigterm_mid_fit_saves_a_last_that_resumes(tmp_path):
    """SIGTERM during epoch 0 (sent from the loader, so it lands while
    steps run): ``fit`` finishes the epoch, saves ``last`` (no validated
    checkpoint) and returns; a fresh experiment resumes it at epoch 1,
    and its next epoch equals the second epoch of a run never stopped."""
    from ctvae_torch.training import install_preemption_handler
    smoke = _smoke()
    exp = _experiment(tmp_path / "a", seed=3)
    real = exp.data.train_dataloader

    def loader(epoch):
        for i, b in enumerate(real(epoch)):
            yield b
            if epoch == 0 and i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
    exp.data.train_dataloader = loader
    previous = install_preemption_handler(exp)
    try:
        assert exp.fit(3, seed=5) == {}
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    assert signal.getsignal(signal.SIGTERM) == previous[signal.SIGTERM]
    spe = exp.data.steps_per_epoch()
    assert exp.global_step == spe
    assert sorted(os.listdir(exp.ckpt.dir)) == ["index.json", "last"]

    resumed = _experiment(tmp_path / "a", seed=11)
    resumed.setup(seed=1)
    resumed.restore_full_state("last")
    assert resumed.start_epoch == 1 and resumed.global_step == spe
    assert smoke._state_equal(resumed.state, exp.state)
    resumed.fit(2, seed=5)
    straight = _experiment(tmp_path / "b", seed=3, ckpt=False)
    straight.fit(2, seed=5)
    assert smoke._state_equal(resumed.state, straight.state)


def test_step_cadence_logging(tmp_path):
    """Every ``log_every`` steps the train metrics (scalars, and the 2-D
    ``ct_adjacency`` as a PNG) and the learning rate at that step; then
    the epoch's validation scalars, ``epoch`` and ``images_per_sec``."""
    from ctvae_torch.utils.logging import ExperimentLogger
    exp = _experiment(tmp_path / "ckpt", seed=3, ckpt=False)
    exp.logger = ExperimentLogger(str(tmp_path / "logs"), "CT")
    exp.log_every = 4
    out = exp.fit(1, seed=5)
    exp.logger.finish()
    with open(os.path.join(exp.logger.log_dir, "scalars.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    steps = exp.data.steps_per_epoch()
    train = {ln["step"] for ln in lines if "lr" in ln}
    assert train == set(range(4, steps + 1, 4))
    lr = {ln["step"]: ln["lr"] for ln in lines if "lr" in ln}
    for step, value in lr.items():
        assert value == pytest.approx(float(exp.lr_schedules[0](step)))
    last = [ln for ln in lines if ln["step"] == steps]
    assert {k for ln in last for k in ln} >= {"val_loss", "epoch",
                                              "images_per_sec"}
    assert any(ln.get("val_loss") == out["val_loss"] for ln in last)
    pngs = sorted(f for f in os.listdir(exp.logger.log_dir)
                  if f.endswith(".png"))
    assert pngs and all(f.startswith(("ct_adjacency_", "ct_mask_"))
                        for f in pngs)
