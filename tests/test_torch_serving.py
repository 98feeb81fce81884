"""The port's serving entry points (ctvae_torch/serving) against the JAX
package's ``serving/export.py::make_inference_fn``, plus the port's rules:
CUDA by default, every JAX param converted, no JAX import anywhere in the
package, and ``chip_smoke.py``'s model section equal to the YAML's.

Tolerance: atol 1e-5 / rtol 1e-4 on values (f32 on both sides).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ctvae_tpu.serving import export as jexport
from ctvae_torch.convert import from_jax_params
from ctvae_torch.serving import inference
from torch_port_common import (ReplayDraws, batch, build_pair, close,
                               recorded_draws, t2n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.mark.parametrize("name", ["reconstruct", "encode", "sample",
                                  "apply_action", "classify_action"])
def test_entry_points_match_jax(monkeypatch, pair, name):
    jm, variables, tm = pair
    x, y, a = batch(7)
    args = {"reconstruct": (x,), "encode": (x,), "sample": (),
            "apply_action": (x, y, a), "classify_action": (x, y)}[name]
    jfn = jax.jit(jexport.make_inference_fn(jm, variables, name,
                                            num_samples=5))
    with recorded_draws(monkeypatch, seed=8) as rec:
        want = jfn(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    draws = ReplayDraws(rec.draws)
    fn = inference.make_inference_fn(tm, name, num_samples=5)
    # the entry point builds its provider from ``generator``; hand it the
    # replayed JAX draws instead
    monkeypatch.setattr(inference, "_draws", lambda model, gen: draws)
    got = fn(*map(torch.from_numpy, args))
    assert draws.done()
    assert not got.requires_grad and got.is_inference()
    close(t2n(got), want)
    if name == "classify_action":
        close(t2n(got).sum(-1), np.ones(len(x)))


def test_entry_points_run_with_a_generator(pair):
    _, _, tm = pair
    x, y, a = map(torch.from_numpy, batch(9))
    outs = {}
    for seed in (0, 0, 1):
        fn = inference.make_inference_fn(tm, "apply_action")
        outs.setdefault(seed, []).append(
            fn(x, y, a, generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(outs[0][0], outs[0][1])     # seeded: reproducible
    assert outs[0][0].shape == x.shape
    assert float(outs[0][0].abs().max()) <= 1.0


def test_available_fns_and_unknown_name(pair):
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    from torch_port_common import MCQ
    jm, _, tm = pair
    assert inference.INFERENCE_FNS == jexport.INFERENCE_FNS
    # every JAX entry point, for the CT model and for the MCQVAE
    assert inference.available_fns(tm) == jexport.available_fns(jm)
    assert inference.available_fns(build_model(dict(MCQ), device="cpu")) \
        == jexport.available_fns(jax_build(dict(MCQ))) == (
            "reconstruct", "encode", "sample")
    with pytest.raises(ValueError):
        inference.make_inference_fn(tm, "decode")


def test_build_model_defaults_to_cuda(monkeypatch):
    from ctvae_torch.models import build_model
    from torch_port_common import SMALL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(dict(SMALL))
    assert build_model(dict(SMALL), device="cpu").device.type == "cpu"


def test_from_jax_params_fills_every_parameter(pair):
    jm, variables, tm = pair
    state = from_jax_params(jax.device_get(variables), tm)
    assert set(state) == set(dict(tm.named_parameters()))
    n_jax = sum(np.size(v) for v in
                jax.tree_util.tree_leaves(variables["params"]))
    assert sum(t.numel() for t in state.values()) == n_jax
    # a leaf without a counterpart, and a parameter left unfilled, raise
    params = jax.device_get(variables["params"])
    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError):
        from_jax_params(extra, tm)
    missing = {k: v for k, v in params.items() if k != "decoder"}
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_params(missing, tm)


def test_chip_smoke_model_params_match_yaml():
    """The smoke run reads its widths from the headline config (without
    PyYAML) and gets what PyYAML reads."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(REPO, "configs", "ct_mcq_vae.yaml")) as f:
        want = yaml.safe_load(f)["model_params"]
    assert smoke.CONFIG == os.path.join(REPO, "configs", "ct_mcq_vae.yaml")
    assert smoke.MODEL_PARAMS == want


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ctvae_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "ctvae_tpu")
    files = _port_files()
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
