"""Exported serving artifacts of models at ``dtype: bfloat16`` on the CPU
(``ctvae_torch/serving/export.py``), against the live port and against
the JAX package's entry functions at bfloat16.

* CTMCQVAE (its five entry points), MCQVAE, VQVAE and VanillaVAE
  (``encode``) built at bfloat16 from a seed, the JAX model holding the
  same values (``port_pair``): each entry point exported with a symbolic
  batch
  (``sample`` at its fixed count), saved and loaded; the
  manifest records the compute dtype; served at batches of 1 and 3 on the
  CPU, each function equals the live port on the same key bit for bit
  (the program runs the port's operations in the port's order, the
  parameters' casts to bfloat16 included), in its dtype; the dtypes of
  its ``out_specs`` are those of ``ctvae_tpu/serving/export.py::
  make_inference_fn``'s outputs at bfloat16; the exported ``encode``
  (no draws, no decisions) equals JAX's within 2 bfloat16 ulps of each
  element plus 4 of its scale (tests/test_torch_bf16.py's bound).
* The drawing and deciding entry points (CTMCQVAE's ``classify_action``,
  which reaches every forward kernel; MCQVAE's, VQVAE's and VanillaVAE's
  ``reconstruct``; the live CT entry points are held against JAX by
  tests/test_torch_bf16.py) against JAX at bfloat16, as
  tests/test_torch_bf16.py holds the live port: JAX's draws recorded and
  replayed, its decisions (VQ codes, the CT layer's argmax, the sampled
  edges) tapped. The live port checks each flip against JAX's margin
  (``Taps``) and continues on JAX's decision; the entry point is
  exported with the same draws and decisions replayed into the trace
  (constants of the program), and the program must equal that live run
  bit for bit, in JAX's output dtype, and JAX's values within 4 bfloat16
  ulps of their scale.
* The artifact's draws reach the model in the dtypes the live port's
  draws reach it (``KeyedDraws`` against ``Draws``).
* ``python -m ctvae_torch.export_model`` on a YAML with ``dtype:
  bfloat16``: the tool's own check (``verify``) passes and the artifact
  serves another batch as the live port does.

JAX runs its XLA paths (no Pallas kernels): its bfloat16 math is the
reference of the port's plain versions here, as in
tests/test_torch_bf16.py's MCQVAE and VanillaVAE tests.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.serving import export, inference
from test_torch_bf16 import VAE_SMALL, VQ_SMALL, Taps, _bf16, assert_ulps
from torch_dp_ranks import TapReplay
from torch_port_common import (MCQ, SMALL, ReplayDraws, batch,
                               one_torch_thread, port_pair, recorded_draws)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFGS = {"CTMCQVAE": SMALL, "MCQVAE": MCQ, "VQVAE": VQ_SMALL,
        "VanillaVAE": VAE_SMALL}
NUM_SAMPLES = 3


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model, variables, the port's model) at bfloat16, the
    JAX variables holding the port's seeded initial values."""
    return {name: port_pair(_bf16(cfg)) for name, cfg in CFGS.items()}


def _args(name: str, B: int, key: int = 9) -> dict:
    x, y, a = (torch.from_numpy(v) for v in batch(B + 30, B=B))
    k = torch.tensor(key)
    return {"reconstruct": (k, x), "encode": (k, x), "sample": (k,),
            "apply_action": (k, x, y, a), "classify_action": (k, x, y)}


def _jax_dtypes(jm, variables, name: str, args) -> list:
    """The dtype of the JAX entry function's output (``eval_shape``: no
    compile)."""
    from ctvae_tpu.serving import export as jexport
    fn = jexport.make_inference_fn(jm, variables, name,
                                   num_samples=NUM_SAMPLES)
    out = jax.eval_shape(fn, jax.random.PRNGKey(0),
                         *(jnp.asarray(a.numpy()) for a in args[1:]))
    return [str(o.dtype) for o in jax.tree_util.tree_leaves(out)]


@pytest.mark.parametrize("name", list(CFGS))
def test_bf16_artifact_round_trip(tmp_path, pairs, name):
    """The model at bfloat16 (CTMCQVAE's every entry point, the others'
    ``encode``): exported (symbolic batch), saved, loaded; served at 1 and
    3 rows equal to the live port on the same key bit for bit; output
    dtypes JAX's; ``encode`` against JAX's."""
    from ctvae_tpu.serving import export as jexport
    jm, variables, tm = pairs[name]
    assert inference.available_fns(tm) == jexport.available_fns(jm)
    fns_live = (inference.available_fns(tm) if name == "CTMCQVAE"
                else ("encode",))
    entries = {n: export.EntryPoint(tm, n, num_samples=NUM_SAMPLES)
               for n in fns_live}
    example = _args(name, 2)
    art = export.save_artifact(str(tmp_path / "art"), {
        n: export.export_fn(entries[n], example[n],
                            poly_batch=n != "sample")
        for n in fns_live}, export.model_manifest(tm))
    fns, manifest = export.load_artifact(art)
    assert manifest["dtype"] == "bfloat16" and manifest["model"] == name
    for n in fns_live:
        spec = manifest["functions"][n]
        assert all(s.startswith("float32[") for s in spec["in_specs"][1:])
        want_dtypes = _jax_dtypes(jm, variables, n, example[n])
        assert [s.split("[")[0] for s in spec["out_specs"]] == want_dtypes
        for B in ((1, 3) if n != "sample" else (0,)):
            args = _args(name, B, key=5 + B)[n]
            got = fns[n](*args)
            with torch.inference_mode():
                live = entries[n](*args)
            assert str(got.dtype).replace("torch.", "") == want_dtypes[0]
            assert got.dtype == live.dtype and torch.equal(got, live), (n, B)
    x = _args(name, 3)["encode"][1]
    want = jax.jit(jexport.make_inference_fn(jm, variables, "encode"))(
        jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    got = fns["encode"](torch.tensor(1), x)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert_ulps(got, want, ulps=2, scale_ulps=4, what="encode")


@pytest.mark.parametrize("name,entry", [
    ("CTMCQVAE", "classify_action"), ("MCQVAE", "reconstruct"),
    ("VQVAE", "reconstruct"), ("VanillaVAE", "reconstruct")])
def test_bf16_artifact_matches_jax(tmp_path, monkeypatch, pairs, name,
                                   entry):
    """The exported program of ``entry`` with JAX's draws and decisions
    replayed into its trace (saved and loaded by the round trip above):
    equal to the live port on them (whose flips were checked against
    JAX's margins) bit for bit, in JAX's dtype, and JAX's values within 4
    bfloat16 ulps of their scale."""
    from ctvae_tpu.serving import export as jexport
    jm, variables, tm = pairs[name]
    args = _args(name, 3)[entry][1:]
    lone = name == "VQVAE"
    taps = Taps(lone=lone)
    with monkeypatch.context() as m:
        taps.jax(m)
        jfn = jax.jit(jexport.make_inference_fn(jm, variables, entry))
        with recorded_draws(m, seed=8) as rec:
            want = jax.block_until_ready(
                jfn(jax.random.PRNGKey(0), *(jnp.asarray(a.numpy())
                                             for a in args)))
    recorded = copy.deepcopy(taps.rec)
    with monkeypatch.context() as m:
        draws = ReplayDraws(rec.draws)
        m.setattr(inference, "_draws", lambda model, source: draws)
        taps.port(m)
        live = inference.make_inference_fn(tm, entry)(*args)
        assert draws.done() and taps.done()
    with monkeypatch.context() as m:
        draws = ReplayDraws(rec.draws)
        m.setattr(inference, "_draws", lambda model, source: draws)
        replay = TapReplay(recorded, lone=lone, check=False)
        replay.install(m.setattr)
        program = export.export_fn(export.EntryPoint(tm, entry),
                                   (torch.tensor(0), *args))
        assert draws.done() and replay.done()
    with torch.inference_mode():
        got = program.module()(torch.tensor(3), *args)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert torch.equal(got, live)
    assert_ulps(got, want, ulps=0, scale_ulps=4, what=f"{name} {entry}")


def _record_dtypes(monkeypatch, cls, seen):
    for kind in ("uniform", "gumbel", "bernoulli", "normal", "randint"):
        orig = getattr(cls, kind)

        def wrapped(self, *a, _orig=orig, _kind=kind, **k):
            out = _orig(self, *a, **k)
            seen.append((_kind, out.dtype))
            return out
        monkeypatch.setattr(cls, kind, wrapped)


@pytest.mark.parametrize("entry", ["reconstruct", "apply_action",
                                   "classify_action"])
def test_keyed_draws_reach_the_model_in_the_live_dtypes(monkeypatch, pairs,
                                                        entry):
    """Each draw of a bfloat16 CT entry point, live (``Draws`` from a
    generator) and through the artifact's ``KeyedDraws``: the same kinds
    in the same order, each in the same dtype (float32; bool and int64
    for the masks and indices), cast by the model where it computes in
    bfloat16, as JAX's draws are."""
    from ctvae_torch.models.base import Draws
    from ctvae_torch.serving.draws import KeyedDraws
    tm = pairs["CTMCQVAE"][2]
    args = _args("CTMCQVAE", 2)[entry]
    live, keyed = [], []
    with monkeypatch.context() as m:
        _record_dtypes(m, Draws, live)
        _record_dtypes(m, KeyedDraws, keyed)
        inference.make_inference_fn(tm, entry)(
            *args[1:], generator=torch.Generator().manual_seed(0))
        assert not keyed
        with torch.inference_mode():
            export.EntryPoint(tm, entry)(*args)
    assert keyed and live == keyed[:len(live)] and len(live) == len(keyed)
    assert {d for _, d in live} <= {torch.float32, torch.bool, torch.int64}


def test_export_model_cli_at_bf16(tmp_path, capsys):
    """``python -m ctvae_torch.export_model`` on configs/synthetic_ct.yaml
    with ``dtype: bfloat16`` in its model_params: the tool's own check
    against the live port passes (4 bfloat16 ulps of each output's scale;
    here equal), the manifest says bfloat16, and the artifact serves a
    batch of 3 equal to the live port on the same key."""
    import os

    from ctvae_torch import export_model
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "synthetic_ct.yaml")
    text = open(src).read().replace("  gamma: 1.5\n",
                                    "  gamma: 1.5\n  dtype: bfloat16\n")
    cfg = tmp_path / "ct_bf16.yaml"
    cfg.write_text(text)
    out = str(tmp_path / "art")
    _, result = export_model.main([
        "-c", str(cfg), "--out", out, "--device", "cpu", "--poly-batch",
        "--batch", "2", "--fns", "encode"])
    assert f"artifact -> {out}" in capsys.readouterr().out
    assert result["manifest"]["dtype"] == "bfloat16"
    assert set(result["max_abs_diff"]) == {"encode"}
    assert all(d == 0.0 for d in result["max_abs_diff"].values())
    model = build_model(read_config(str(cfg))["model_params"], device="cpu")
    assert model.compute_dtype == torch.bfloat16
    fns, manifest = export.load_artifact(out)
    for n, fn in fns.items():
        args = _args("CTMCQVAE", 3)[n]
        with torch.inference_mode():
            want = export.EntryPoint(model, n)(*args)
        assert torch.equal(fn(*args), want), n


#: one member of each group of the zoo ported at bfloat16 after the first
#: four, and the entry point served: the standard backbone's loss-only
#: members, those with their own heads or draws (IWAE's 5-D
#: ``reconstruct``), those with their own layers (HVAE's drawing
#: ``encode``)
ZOO = {"BetaVAE": ("encode", dict(VAE_SMALL, name="BetaVAE")),
       "IWAE": ("reconstruct", dict(VAE_SMALL, name="IWAE", num_samples=2)),
       "HVAE": ("encode", dict(name="HVAE", in_channels=3, latent1_dim=8,
                               latent2_dim=6, hidden_dims=[8, 16],
                               img_size=16))}


@pytest.mark.parametrize("name", list(ZOO))
def test_bf16_zoo_artifact_round_trip(tmp_path, name):
    """A member of each later group at bfloat16 (built from a seed):
    its entry point exported with a symbolic batch, saved and loaded, the
    manifest's dtype bfloat16; served on a batch of 3 on the CPU, equal to
    the live port on the same key bit for bit, in float32 (the heads and
    the decoder widen their outputs)."""
    from ctvae_torch.models import build_model
    fn, cfg = ZOO[name]
    tm = build_model(_bf16(cfg), device="cpu",
                     generator=torch.Generator().manual_seed(3))
    entry = export.EntryPoint(tm, fn)
    art = export.save_artifact(str(tmp_path / "art"), {
        fn: export.export_fn(entry, _args(name, 2)[fn], poly_batch=True)},
        export.model_manifest(tm))
    fns, manifest = export.load_artifact(art)
    assert manifest["dtype"] == "bfloat16" and manifest["model"] == name
    args = _args(name, 3, key=11)[fn]
    got = fns[fn](*args)
    with torch.inference_mode():
        live = entry(*args)
    assert got.dtype == live.dtype == torch.float32
    assert got.shape[0] == 3 and torch.equal(got, live)
    assert bool(torch.isfinite(got).all())
