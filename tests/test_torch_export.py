"""The port's exported serving artifacts (``ctvae_torch/serving/export.py``)
and the kernels' custom ops (``ctvae_torch/ops/library.py``) on the CPU,
against the JAX package's ``serving/export.py`` where the outputs are
comparable.

* every ``ctvae::`` op through ``torch.library.opcheck``: its schema, its
  fake kernel (shapes, dtypes and strides of the CPU kernel's outputs),
  its registered gradient and its trace;
* ``KeyedDraws``: the same numbers for a key, others for another key, the
  moments of each kind (bounds from the sample size), ``randint`` in
  bounds, every ``permutation`` row a permutation;
* the round trips of ``tests/test_export.py``: ``available_fns`` against
  JAX's, VanillaVAE's three functions, the CT model's five (classify
  rows sum to 1, a key repeats its output), a symbolic batch at 1 / 4 / 7,
  ConditionalVAE with labels, HVAE's drawing encode and LVAE's rungs;
* against JAX: the exported ``encode`` of each deterministic encoder
  equals JAX's ``make_inference_fn(...)("encode")`` on the converted
  params; the CT model's drawing entry points, exported with JAX's
  recorded draws replayed into the trace (constants of the program),
  equal JAX's outputs.

Tolerances: artifact against the live port (the same ops, run by the
program) rtol 1e-4 / atol 1e-5, as JAX's tests hold theirs; against JAX
atol 1e-5 / rtol 1e-4 (f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.serving import export, inference
from ctvae_torch.serving.draws import KeyedDraws
from torch_port_common import (SMALL, ReplayDraws, batch, build_pair, close,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMG = 16
GAUSS = dict(in_channels=3, latent_dim=8, hidden_dims=[8, 16], img_size=IMG)


def _images(seed: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(n, IMG, IMG, 3)).astype(np.float32))


def _port(params: dict):
    from ctvae_torch.models import build_model
    return build_model(dict(params), device="cpu")


def _round_trip(tmp_path, model, args: dict, *, poly_batch=False,
                num_samples=64):
    """Export ``model``'s entry points at ``args`` (name -> arguments, the
    key first), save, load; returns (loaded fns, manifest, live entry
    points)."""
    entries = {n: export.EntryPoint(model, n, num_samples=num_samples)
               for n in args}
    art = export.save_artifact(str(tmp_path / "art"), {
        n: export.export_fn(entries[n], a, poly_batch=poly_batch)
        for n, a in args.items()}, {"model": type(model).__name__})
    fns, manifest = export.load_artifact(art)
    return fns, manifest, entries


def _live(entry, args):
    with torch.inference_mode():
        return entry(*args)


def _same(got, want):
    np.testing.assert_allclose(t2n(got), t2n(want), rtol=1e-4, atol=1e-5)


# --- the kernels as custom ops -----------------------------------------------

def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, grad=True):
        return torch.randn(*shape, generator=g).requires_grad_(grad)
    B, S, T, H, F, K = 2, 5, 6, 3, 4, 2
    xl, xr = r(B, S, H, grad=False), r(B, T, H, grad=False)
    w2, b1, b2 = r(H, grad=False), r(H, grad=False), r((), grad=False)
    from ctvae_torch.ops import library
    out = library.pairwise_fwd(xl, xr, w2, b1, b2, 0.01)
    adj = torch.rand(B, T, T, generator=g)
    mask = adj > 0.3
    gat = [r(B, T, H, F, grad=False), r(B, T, H, F, grad=False), adj, mask,
           r(H, F, grad=False), r(H, F, grad=False)]
    _, alpha = library.gat_fwd_alpha(*gat, 0.2)
    adj_l = torch.rand(B, S, T, generator=g)
    return {
        "vq_l2_argmin": (r(7, 4), r(5, 4)),
        "pairwise_fwd-shared": (r(B, S, H), r(B, T, H), r(H), r(H), r(()),
                                0.01),
        "pairwise_fwd-per_sample": (r(B, S, H), r(B, T, H), r(B, H),
                                    r(B, H), r(B), 0.2),
        "pairwise_bwd": (xl, xr, w2, b1, b2, out, r(B, S, T, grad=False),
                         0.01),
        "gat_fwd": (*gat, 0.2),
        "gat_fwd_alpha": (r(B, T, H, F), r(B, T, H, F),
                          adj.clone().requires_grad_(), mask, r(H, F),
                          r(H, F), 0.2),
        "gat_bwd": (*gat, alpha, r(B, T, H, F, grad=False), 0.2),
        "gat_logits_fwd-shared": (r(B, S, K, F), r(B, T, K, F),
                                  adj_l.clone().requires_grad_(), r(K, F),
                                  r(K, F), 0.2),
        "gat_logits_fwd-per_sample": (r(B, S, K, F), r(B, T, K, F),
                                      adj_l.clone().requires_grad_(),
                                      r(B, K, F), r(B, K, F), 0.2),
        "gat_logits_bwd": (r(B, S, K, F, grad=False),
                           r(B, T, K, F, grad=False), adj_l,
                           r(K, F, grad=False), r(K, F, grad=False),
                           r(B, S, T, K, grad=False), 0.2)}


@pytest.mark.parametrize("case", [
    "vq_l2_argmin", "pairwise_fwd-shared", "pairwise_fwd-per_sample",
    "pairwise_bwd", "gat_fwd", "gat_fwd_alpha", "gat_bwd",
    "gat_logits_fwd-shared", "gat_logits_fwd-per_sample", "gat_logits_bwd"])
def test_custom_op_passes_opcheck(case):
    """Schema, fake kernel, autograd registration and trace of each op on
    the CPU (its plain version); the three differentiable ones with inputs
    that need gradients."""
    from ctvae_torch.ops import library
    op = getattr(library, case.split("-")[0])
    assert op._qualname == f"ctvae::{case.split('-')[0]}"
    torch.library.opcheck(op, _opcheck_cases()[case])


# --- keyed draws -------------------------------------------------------------

def _all_kinds(d: KeyedDraws):
    return [d.uniform((3, 50)), d.normal((40,)), d.gumbel((2, 30)),
            d.bernoulli(0.4, (60,)), d.randint(2, 9, (70,)),
            d.gamma(torch.full((30,), 8.0)), d.cauchy((50,)),
            d.permutation(4, 12)]


def test_keyed_draws_repeat_for_a_key_and_differ_across_keys():
    """One key gives the same numbers draw for draw; another key, and the
    next draw of one provider, others."""
    a, b = (_all_kinds(KeyedDraws(torch.tensor(12))) for _ in range(2))
    c = _all_kinds(KeyedDraws(torch.tensor(13)))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    d = KeyedDraws(torch.tensor(12))
    assert not torch.equal(d.uniform((100,)), d.uniform((100,)))
    # the high word of the key counts too
    assert not torch.equal(KeyedDraws(torch.tensor(2 ** 33)).uniform((50,)),
                           KeyedDraws(torch.tensor(0)).uniform((50,)))


N = 200_000


@pytest.mark.parametrize("kind", ["uniform", "normal", "gumbel", "bernoulli",
                                  "gamma", "gamma_below_one", "cauchy"])
def test_keyed_draw_moments(kind):
    """Mean and variance (cauchy: median and quartiles) of 200,000 draws
    within about five standard errors of the distribution's."""
    d = KeyedDraws(torch.tensor(3))
    if kind == "uniform":
        x, mean, var = d.uniform((N,)).double(), 0.5, 1 / 12
        assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
    elif kind == "normal":
        x, mean, var = d.normal((N,)).double(), 0.0, 1.0
    elif kind == "gumbel":
        x, mean, var = d.gumbel((N,)).double(), 0.5772157, np.pi ** 2 / 6
    elif kind == "bernoulli":
        x = d.bernoulli(0.3, (N,))
        assert x.dtype == torch.bool
        x, mean, var = x.double(), 0.3, 0.21
    elif kind == "gamma":
        x, mean, var = d.gamma(torch.full((N,), 8.0)).double(), 8.0, 8.0
    elif kind == "gamma_below_one":
        x, mean, var = d.gamma(torch.full((N,), 0.5)).double(), 0.5, 0.5
        assert float(x.min()) >= 0.0
    else:
        x = d.cauchy((N,)).double()
        q = torch.quantile(x[:50_000], torch.tensor(
            [0.25, 0.5, 0.75], dtype=torch.float64))
        np.testing.assert_allclose(q.numpy(), [-1.0, 0.0, 1.0], atol=0.03)
        return
    assert x.dtype == torch.float64 and x.shape == (N,)
    assert abs(float(x.mean()) - mean) < 5 * (var / N) ** 0.5
    assert abs(float(x.var()) - var) < 0.02 * var


def test_keyed_randint_bounds_and_permutation_rows():
    d = KeyedDraws(torch.tensor(5))
    r = d.randint(-3, 4, (10_000,))
    assert r.dtype == torch.int64
    assert int(r.min()) == -3 and int(r.max()) == 3
    counts = torch.bincount(r + 3).double()
    assert float((counts / 10_000 - 1 / 7).abs().max()) < 0.02
    p = d.permutation(64, 33)
    assert p.dtype == torch.int64 and p.shape == (64, 33)
    assert torch.equal(p.sort(1).values, torch.arange(33).expand(64, 33))
    assert len({tuple(row) for row in p.tolist()}) == 64


def test_keyed_draws_trace_with_a_symbolic_batch(tmp_path):
    """A draw of a symbolic batch's shape stays symbolic in the program:
    the artifact's draws at every batch size equal the live ones."""
    class Noisy(torch.nn.Module):
        def forward(self, key, *arrays):
            (x,), d = arrays, KeyedDraws(key)
            return x + d.normal(x.shape) + d.gumbel((x.shape[0], 2)).sum(1,
                                                                         True)
    x = torch.zeros(5, 3)
    exp = export.export_fn(Noisy(), (torch.tensor(4), x), poly_batch=True)
    fn = exp.module()
    for b in (1, 5, 9):
        xb = torch.zeros(b, 3)
        assert torch.equal(fn(torch.tensor(4), xb),
                           Noisy()(torch.tensor(4), xb))


# --- round trips (tests/test_export.py's) ------------------------------------

def test_available_fns_match_jax():
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.serving import export as jexport
    assert inference.INFERENCE_FNS == jexport.INFERENCE_FNS
    for params in (dict(name="VanillaVAE", **GAUSS), SMALL,
                   dict(name="VQVAE", in_channels=3, embedding_dim=8,
                        num_embeddings=8, hidden_dims=[8, 16],
                        img_size=IMG)):
        assert inference.available_fns(_port(params)) == \
            jexport.available_fns(jax_build(dict(params)))


def test_vanilla_artifact_round_trip(tmp_path):
    model = _port(dict(name="VanillaVAE", **GAUSS))
    key, x = torch.tensor(7), _images(0, 4)
    args = {"reconstruct": (key, x), "encode": (key, x), "sample": (key,)}
    fns, manifest, entries = _round_trip(tmp_path, model, args,
                                         num_samples=3)
    assert manifest["model"] == "VanillaVAE" and set(fns) == set(args)
    assert manifest["torch_version"] == torch.__version__
    for name in fns:
        got = fns[name](*args[name])
        assert not got.requires_grad
        _same(got, _live(entries[name], args[name]))
    assert fns["reconstruct"](key, x).shape == (4, IMG, IMG, 3)
    assert fns["sample"](key).shape == (3, IMG, IMG, 3)
    assert fns["encode"](key, x).shape == (4, 8)


def test_ct_artifact_round_trip(tmp_path):
    model = _port(SMALL)
    x, y, a = map(torch.from_numpy, batch(1, B=2))
    key = torch.tensor(9)
    args = {"reconstruct": (key, x), "encode": (key, x), "sample": (key,),
            "apply_action": (key, x, y, a), "classify_action": (key, x, y)}
    fns, manifest, entries = _round_trip(tmp_path, model, args,
                                         num_samples=3)
    assert manifest["functions"]["apply_action"]["in_specs"] == [
        "int64[]", "float32[2, 16, 16, 3]", "float32[2, 16, 16, 3]",
        "float32[2, 8]"]
    for name in args:
        _same(fns[name](*args[name]), _live(entries[name], args[name]))
    probs = fns["classify_action"](*args["classify_action"])
    assert probs.shape == (2, 8)
    close(t2n(probs).sum(-1), np.ones(2))
    # stochastic but keyed: the same key repeats its output, another
    # key draws another intervention
    again = fns["apply_action"](*args["apply_action"])
    assert torch.equal(again, fns["apply_action"](*args["apply_action"]))
    assert not torch.equal(again, fns["apply_action"](torch.tensor(10), x, y,
                                                      a))


def test_poly_batch_serves_any_batch_size(tmp_path):
    model = _port(dict(name="VanillaVAE", **GAUSS))
    key = torch.tensor(3)
    fns, manifest, entries = _round_trip(
        tmp_path, model, {"reconstruct": (key, _images(0, 4))},
        poly_batch=True)
    spec = manifest["functions"]["reconstruct"]
    assert spec["in_specs"] == ["int64[]", "float32[b, 16, 16, 3]"]
    assert spec["out_specs"] == ["float32[b, 16, 16, 3]"]
    assert spec["device"] == "cpu"
    for b in (1, 4, 7):
        xb = _images(b, b)
        got = fns["reconstruct"](key, xb)
        assert got.shape == (b, IMG, IMG, 3)
        _same(got, _live(entries["reconstruct"], (key, xb)))


def test_poly_batch_from_an_example_batch_of_one(tmp_path):
    """``torch.export`` would take a size-1 batch for a constant: the
    example is traced at 2 rows, and the program serves 1 and 3."""
    model = _port(SMALL)
    x, y, _ = map(torch.from_numpy, batch(2, B=3))
    key = torch.tensor(4)
    fns, manifest, entries = _round_trip(
        tmp_path, model, {"classify_action": (key, x[:1], y[:1])},
        poly_batch=True)
    assert manifest["functions"]["classify_action"]["in_specs"][1] == \
        "float32[b, 16, 16, 3]"
    for b in (1, 3):
        args = (key, x[:b], y[:b])
        got = fns["classify_action"](*args)
        assert got.shape == (b, 8)
        _same(got, _live(entries["classify_action"], args))


def test_conditional_vae_needs_labels(tmp_path):
    model = _port(dict(name="ConditionalVAE", num_classes=5, **GAUSS))
    x = _images(2, 4)
    labels = torch.nn.functional.one_hot(torch.arange(4), 5).float()
    key = torch.tensor(5)
    args = {"reconstruct": (key, x, labels), "encode": (key, x, labels),
            "sample": (key, labels.repeat(2, 1)[:6])}
    fns, _, entries = _round_trip(tmp_path, model, args, num_samples=6)
    for name in args:
        _same(fns[name](*args[name]), _live(entries[name], args[name]))
    assert fns["sample"](*args["sample"]).shape == (6, IMG, IMG, 3)


@pytest.mark.parametrize("name,kw", [
    ("HVAE", dict(latent1_dim=8, latent2_dim=4, hidden_dims=[8, 16],
                  img_size=IMG)),
    ("LVAE", dict(latent_dims=[4, 8], hidden_dims=[8, 16], img_size=IMG))])
def test_encode_export_stochastic_and_ladder(tmp_path, name, kw):
    """HVAE's encode draws (its z2, from the key); LVAE's returns rungs of
    (mu, log_var): the entry point flattens the first array."""
    model = _port(dict(name=name, in_channels=3, **kw))
    key, x = torch.tensor(13), _images(4, 2)
    fns, _, entries = _round_trip(tmp_path, model, {"encode": (key, x)})
    got = fns["encode"](key, x)
    assert got.ndim == 2 and got.shape[0] == 2
    _same(got, _live(entries["encode"], (key, x)))
    if name == "HVAE":
        assert not torch.equal(got, fns["encode"](torch.tensor(14), x))


# --- against JAX ------------------------------------------------------------

def _jax_pair(params: dict):
    """(JAX model, variables, the port's model with them converted)."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.convert import from_jax_params
    jm = jax_build(dict(params))
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    variables = jax.device_get(jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        dict(zip(("params", "reparam", "gumbel", "noise", "dropout"), keys)),
        jnp.asarray(t2n(_images(0, 2)))))
    tm = _port(params)
    tm.load_state_dict(from_jax_params(variables, tm))
    return jm, variables, tm


@pytest.mark.parametrize("params", [
    dict(name="VanillaVAE", **GAUSS),
    dict(name="VQVAE", in_channels=3, embedding_dim=8, num_embeddings=16,
         hidden_dims=[8, 16], img_size=IMG),
    SMALL], ids=["VanillaVAE", "VQVAE", "CTMCQVAE"])
def test_exported_encode_matches_jax(tmp_path, params):
    """A deterministic encoder's artifact against JAX's ``encode`` entry
    point on the converted parameters, at a symbolic batch of 3."""
    from ctvae_tpu.serving import export as jexport
    if params is SMALL:
        jm, variables, tm = build_pair(seed=0)
    else:
        jm, variables, tm = _jax_pair(params)
    x = _images(6, 3)
    fns, _, _ = _round_trip(tmp_path, tm, {"encode": (torch.tensor(0), x)},
                            poly_batch=True)
    want = jax.jit(jexport.make_inference_fn(jm, variables, "encode"))(
        jax.random.PRNGKey(0), jnp.asarray(t2n(x)))
    close(t2n(fns["encode"](torch.tensor(1), x)), want)


@pytest.mark.parametrize("name", ["reconstruct", "sample", "apply_action",
                                  "classify_action"])
def test_exported_ct_entry_points_match_jax(tmp_path, monkeypatch, name):
    """The CT model's drawing entry points exported at a fixed batch with
    JAX's recorded draws replayed into the trace (``inference._draws``:
    the draws become constants of the program): the artifact, served on
    another key, equals JAX's output."""
    from ctvae_tpu.serving import export as jexport
    jm, variables, tm = build_pair(seed=0)
    x, y, a = batch(7)
    args = {"reconstruct": (x,), "sample": (), "apply_action": (x, y, a),
            "classify_action": (x, y)}[name]
    jfn = jax.jit(jexport.make_inference_fn(jm, variables, name,
                                            num_samples=5))
    with recorded_draws(monkeypatch, seed=8) as rec:
        want = jfn(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    draws = ReplayDraws(rec.draws)
    with monkeypatch.context() as m:
        m.setattr(inference, "_draws", lambda model, source: draws)
        exp = export.export_fn(export.EntryPoint(tm, name, num_samples=5),
                               (torch.tensor(0), *map(torch.from_numpy,
                                                      args)))
    assert draws.done()
    art = export.save_artifact(str(tmp_path / "art"), {name: exp})
    fns, _ = export.load_artifact(art)
    close(t2n(fns[name](torch.tensor(3), *map(torch.from_numpy, args))),
          want)
