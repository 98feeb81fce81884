"""``python -m ctvae_torch.export_model`` on the CPU, and an artifact served
by a process that imports no model code.

* the CLI on ``configs/synthetic_vae.yaml`` and ``configs/synthetic_ct.yaml``
  at random init (with its warning) and from a port checkpoint: every
  entry point the model serves (or ``--fns``'), exported with a symbolic
  batch, saved, reloaded and verified by the tool itself; the artifact
  served again here at another batch size against the live port on the
  same key (rtol 1e-4 / atol 1e-5), and, from a checkpoint, against a
  model restored from it (and not the random init);
* a subprocess that loads the CT artifact and serves it, with
  ``ctvae_torch.models`` not in its ``sys.modules``: its outputs equal the
  live port's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctvae_torch import export_model
from ctvae_torch.config import read_config
from ctvae_torch.serving import export, inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"vae": os.path.join(REPO, "configs", "synthetic_vae.yaml"),
           "ct": os.path.join(REPO, "configs", "synthetic_ct.yaml")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name: str, ckpt=None):
    from ctvae_torch.models import build_model
    from ctvae_torch.utils.checkpoint import load_weights_only
    model = build_model(read_config(CONFIGS[name])["model_params"],
                        device="cpu")
    if ckpt:
        load_weights_only(ckpt, model)
    return model


def _args(B: int, key: int = export_model.KEY):
    rng = np.random.default_rng(B)
    x, y = (torch.from_numpy(rng.uniform(size=(B, 16, 16, 3)).astype(
        np.float32)) for _ in range(2))
    a = torch.nn.functional.one_hot(torch.arange(B) % 8, 8).float()
    k = torch.tensor(key)
    return {"reconstruct": (k, x), "encode": (k, x), "sample": (k,),
            "apply_action": (k, x, y, a), "classify_action": (k, x, y)}


def _serve_against(art, model, B: int) -> dict:
    """Each function of the artifact at batch B against the live port."""
    fns, manifest = export.load_artifact(art)
    args = _args(B)
    for name, fn in fns.items():
        got = fn(*args[name])
        with torch.inference_mode():
            want = export.EntryPoint(model, name)(*args[name])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    return manifest


@pytest.fixture(scope="module")
def ct_artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ct") / "art")
    export_model.main(["-c", CONFIGS["ct"], "--out", out, "--device", "cpu",
                       "--poly-batch", "--batch", "4"])
    return out


@pytest.mark.parametrize("name", ["vae", "ct"])
def test_cli_exports_at_random_init(tmp_path, capsys, ct_artifact, name):
    out = ct_artifact
    if name == "vae":
        out = str(tmp_path / "art")
        export_model.main(["-c", CONFIGS[name], "--out", out, "--device",
                           "cpu", "--poly-batch", "--batch", "4"])
        captured = capsys.readouterr()
        assert "WARNING: no --ckpt given" in captured.err
        assert f"artifact -> {out}" in captured.out
    model = _model(name)
    manifest = _serve_against(out, model, 3)
    assert set(manifest["functions"]) == set(
        inference.available_fns(model))
    assert manifest["poly_batch"] and manifest["checkpoint"] is None
    assert manifest["model"] == type(model).__name__
    assert manifest["functions"]["encode"]["in_specs"][1] == \
        "float32[b, 16, 16, 3]"
    assert manifest["functions"]["sample"]["out_specs"] == [
        "float32[64, 16, 16, 3]"]
    assert os.path.exists(os.path.join(out, "reconstruct.pt2"))


@pytest.mark.parametrize("name", ["vae", "ct"])
def test_cli_exports_a_port_checkpoint(tmp_path, capsys, name):
    """A checkpoint file of the port's form (``{"model": state_dict}``)
    with every parameter moved: the artifact serves the restored weights."""
    model = _model(name)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator(
            ).manual_seed(p.numel())))
    ckpt = str(tmp_path / "last")
    torch.save({"model": model.state_dict()}, ckpt)
    out = str(tmp_path / "art")
    export_model.main(["-c", CONFIGS[name], "--out", out, "--device", "cpu",
                       "--ckpt", ckpt, "--fns", "reconstruct,encode",
                       "--poly-batch", "--batch", "2"])
    assert "WARNING" not in capsys.readouterr().err
    manifest = _serve_against(out, _model(name, ckpt), 5)
    assert manifest["checkpoint"] == ckpt
    assert set(manifest["functions"]) == {"reconstruct", "encode"}
    fns, _ = export.load_artifact(out)
    with torch.inference_mode():
        fresh = export.EntryPoint(_model(name), "encode")(*_args(5)["encode"])
    assert not torch.allclose(fns["encode"](*_args(5)["encode"]), fresh)


SERVE = """
import json, sys
import torch
from ctvae_torch.serving.export import load_artifact
art, inputs, outputs = sys.argv[1:]
fns, manifest = load_artifact(art)
args = torch.load(inputs)
torch.save({n: fns[n](*args[n]) for n in fns}, outputs)
print(json.dumps({"models_imported": "ctvae_torch.models" in sys.modules,
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("ctvae_torch"))}))
"""


def test_artifact_serves_without_model_code(tmp_path, ct_artifact):
    args = _args(3, key=11)
    torch.save(args, tmp_path / "inputs.pt")
    proc = subprocess.run(
        [sys.executable, "-c", SERVE, ct_artifact, str(tmp_path / "inputs.pt"),
         str(tmp_path / "outputs.pt")], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not report["models_imported"], report["modules"]
    assert "ctvae_torch.ops.library" in report["modules"]
    got = torch.load(tmp_path / "outputs.pt")
    model = _model("ct")
    assert set(got) == set(inference.available_fns(model))
    for name, out in got.items():
        with torch.inference_mode():
            want = export.EntryPoint(model, name)(*args[name])
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
