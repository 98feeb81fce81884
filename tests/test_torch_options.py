"""The CT and MCQ model options of the port against the JAX package at
small widths: ``noise`` exo / endo (the forward, one train step per mode,
the identity fast path, the serving entry points), the rotation
estimator (``rotate_to``), the EMA codebook with dead-code revival
(buffers against JAX's ``vq_stats`` after a train step, MCQVAE and
CTMCQVAE with ``update_parameters: ct_layer``; the multi-step train step,
checkpoints, ``from_jax_params``, the eval step) and the model registry's
fields against the JAX dataclasses.

Random draws (the noise normals, the revival ``randint``) are recorded on
the JAX side and replayed into the port (tests/torch_port_common.py).
Tolerances: values atol 1e-5 / rtol 1e-4; the train step as in
tests/test_torch_training.py; the EMA buffers atol 1e-5 / rtol 1e-4;
port-only comparisons (multi-step against single steps, resumes) exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from ctvae_torch.models.base import Draws
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (MCQ, SMALL, ReplayDraws, assert_step_matches,
                               batch, build_pair, close, jax_rngs,
                               jax_train_step_state, one_torch_thread,
                               recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXP = dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0)
EXP_CT = dict(EXP, update_parameters="ct_layer")
MODES = ("base", "action", "causal")
# decay 0.9 and threshold 0.5: after one step a code assigned to fewer
# than 5 of a codebook's 48 rows (B = 3, 4 x 4) is revived, the others
# are not
EMA = dict(ema=True, ema_decay=0.9, revive_threshold=0.5,
           grad_estimator="rotation")
# the CT options together: the endo noise node, the EMA codebook with
# revival, the rotation estimator, trained with update_parameters:
# ct_layer as the two-stage recipe trains it
CT_OPTIONS = {"exo": (dict(noise="exo"), EXP),
              "endo-ema-ct_layer": (dict(noise="endo", **EMA), EXP_CT)}

_PAIRS = {}


def _pair(**extra):
    """``build_pair`` of SMALL with ``extra``, built once per module."""
    key = tuple(sorted(extra.items()))
    if key not in _PAIRS:
        _PAIRS[key] = build_pair(dict(SMALL, **extra), seed=0)
    return _PAIRS[key]


def _mcq_pair():
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    key = ("mcq",)
    if key not in _PAIRS:
        cfg = dict(MCQ, **EMA)
        jm = jax_build(cfg)
        x, _, _ = batch(0, B=2)
        variables = jax.jit(jm.init)(jax_rngs(0), jnp.asarray(x))
        tm = build_model(cfg, device="cpu")
        tm.load_state_dict(from_jax_params(jax.device_get(variables), tm))
        _PAIRS[key] = (jm, variables, tm)
    return _PAIRS[key]


def _buffers(tm):
    return {n: b for n, b in tm.named_buffers() if "quantizers_" in n}


def _port_step(tm, mode, b, draws, exp):
    """One port train step of ``mode`` with the JAX draws replayed."""
    replay = ReplayDraws(draws)
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm, 4))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tstate, "Draws", lambda gen, device: replay)
        metrics = tstate.make_train_step(mode)(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert replay.done() and state.step == 1
    return metrics


def _check_step(monkeypatch, pair, mode, exp, seed=12):
    """One train step of ``mode`` in the port and in JAX from the same
    variables and draws: every metric, ``grad_norm``, every gradient and
    parameter after Adam, and the EMA buffers (if any) against JAX's
    ``vq_stats``. Returns (the JAX draws, the port model after the step,
    its buffers before it, JAX's vq_stats after it)."""
    jm, variables, tm0 = pair
    tm = copy.deepcopy(tm0)
    before = {n: b.clone() for n, b in _buffers(tm).items()}
    x, y, a = batch(11)
    b = {"image": x, "input_y": y, "action": a}
    j_params, j_grads, j_metrics, draws, j_state = jax_train_step_state(
        jm, variables, mode, {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=seed, exp=exp)
    metrics = _port_step(tm, mode, b, draws, exp)
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v)
    close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
          rtol=1e-5)
    assert_step_matches(tm, j_params, j_grads, exp["LR"])
    if "vq_stats" in j_state:
        want = from_jax_params({"params": j_params, **j_state}, tm)
        for n, t in _buffers(tm).items():
            close(t2n(t), want[n].numpy())
    return draws, tm, before, j_state.get("vq_stats")


# --- noise: exo / endo --------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("options", list(CT_OPTIONS))
def test_noise_train_step_matches_jax(monkeypatch, options, mode):
    """One train step per mode of a CTMCQVAE under each noise: the noise
    draws (a normal of the latent's shape for exo, of [B, N] per call for
    endo, the identity pass's discarded one in base mode) replayed;
    losses, metrics, every gradient and parameter. The endo model also
    has the EMA codebook with revival and the rotation estimator and
    trains ``ct_layer`` alone: its buffers follow the encoder's indices
    (``update_stats``) against JAX's ``vq_stats``, although no backbone
    parameter is trained, and the revival's ``randint`` draws (one per
    codebook) come before the CT layer's; some codes are revived, not
    all."""
    extra, exp = CT_OPTIONS[options]
    draws, tm, before, vq_stats = _check_step(monkeypatch, _pair(**extra),
                                              mode, exp)
    normals = [a.shape for k, a in draws if k == "normal"]
    B, S, N = 3, 2 * 4 * 4, SMALL["num_embeddings"]
    A = SMALL["action_dim"]
    per_call = {"exo": (B, S, N), "endo": (B, N)}[extra["noise"]]
    want = {"base": [per_call, per_call], "action": [per_call],
            "causal": [(A * B,) + per_call[1:]]}[mode]
    assert normals == want
    if extra.get("ema"):
        assert [k for k, _ in draws[:2]] == ["randint", "randint"]
        assert all(0 < n < N for n in _revived(vq_stats))
        for n, t in _buffers(tm).items():
            assert not torch.equal(t, before[n]), n


def _run_jax(jm, variables, monkeypatch, mode, x, y, a, seed):
    kwargs = {"base": {}, "action": dict(input_y=y, action=a),
              "causal": dict(input_y=y, action=a)}[mode]

    @jax.jit
    def run(variables, x, kwargs):
        out = jm.apply(variables, x, mode=mode, train=False,
                       rngs=jax_rngs(seed), **kwargs)
        losses = jm.apply(variables, out, method=jm.loss_function)
        del out["mode"]
        return out, losses

    with recorded_draws(monkeypatch, seed=seed) as rec:
        out, losses = run(variables, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in kwargs.items()})
    return out, losses, rec.draws


@pytest.mark.parametrize("mode", MODES)
def test_exo_forward_matches_jax(monkeypatch, mode):
    """The eval forward of every mode under ``noise='exo'`` (JAX draws the
    noise in eval too): recons, losses and metrics."""
    jm, variables, tm = _pair(noise="exo")
    x, y, a = batch(5)
    j_out, j_loss, rec = _run_jax(jm, variables, monkeypatch, mode, x, y, a,
                                  seed=6)
    assert any(k == "normal" for k, _ in rec)
    draws = ReplayDraws(rec)
    with torch.no_grad():
        t_out = tm(torch.from_numpy(x), input_y=torch.from_numpy(y),
                   action=torch.from_numpy(a), mode=mode, draws=draws)
        t_loss = tm.loss_function(t_out)
    assert draws.done()
    close(t2n(t_out["recons"]), j_out["recons"])
    for k, v in j_out["metrics"].items():
        close(t2n(t_out["metrics"][k]), v)
    for k in ("loss", "Reconstruction_Loss", "VQ_Loss", "CT_Loss"):
        close(t2n(t_loss[k]), j_loss[k])


@pytest.mark.parametrize("name", ["reconstruct", "encode", "sample",
                                  "apply_action", "classify_action"])
def test_serving_under_endo_matches_jax(monkeypatch, name):
    """Each serving entry point of an ``endo`` model against JAX's
    ``make_inference_fn``, the noise node's draws replayed from JAX."""
    from ctvae_tpu.serving import export as jexport
    from ctvae_torch.serving import inference
    jm, variables, tm = _pair(**CT_OPTIONS["endo-ema-ct_layer"][0])
    x, y, a = batch(7)
    args = {"reconstruct": (x,), "encode": (x,), "sample": (),
            "apply_action": (x, y, a), "classify_action": (x, y)}[name]
    jfn = jax.jit(jexport.make_inference_fn(jm, variables, name,
                                            num_samples=5))
    with recorded_draws(monkeypatch, seed=8) as rec:
        want = jfn(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    if name in ("reconstruct", "apply_action", "classify_action"):
        assert any(k == "normal" for k, _ in rec.draws)
    draws = ReplayDraws(rec.draws)
    fn = inference.make_inference_fn(tm, name, num_samples=5)
    monkeypatch.setattr(inference, "_draws", lambda model, gen: draws)
    got = fn(*map(torch.from_numpy, args))
    assert draws.done()
    close(t2n(got), want)


@pytest.mark.parametrize("noise", ["off", "exo", "endo"])
def test_identity_fast_path_matches_general(noise):
    """``_compute_y_identity`` equals ``_compute_y`` under an identity
    adjacency, values and gradients, under each noise (the endo pass
    draws its noise node and discards it: the draws stay in step)."""
    from ctvae_torch.models.ct_vae import CausalTransition
    torch.manual_seed(0)
    ct = CausalTransition(8, 4, (16, 8), noise=noise)
    from ctvae_torch.models import init_weights
    init_weights(ct, torch.Generator().manual_seed(3))
    B, S, N = 2, 6, 8
    latent = torch.nn.functional.one_hot(
        torch.from_numpy(np.random.default_rng(3).integers(0, N, (B, S))),
        N).float()
    action = torch.zeros(B, 4)
    mask = torch.zeros(B, S, 1)
    identity = torch.eye(S).expand(B, S, S)

    def run(fast):
        ct.zero_grad()
        draws = Draws(torch.Generator().manual_seed(5))
        y = (ct._compute_y_identity(latent, draws) if fast else
             ct._compute_y(latent, action, identity, mask, draws))
        torch.sum(torch.square(y)).backward()
        after = float(draws.uniform((1,)))      # the draws stay in step
        return y.detach(), {n: (p.grad.clone() if p.grad is not None
                                else torch.zeros_like(p))
                            for n, p in ct.named_parameters()}, after

    y_gen, g_gen, u_gen = run(False)
    y_fast, g_fast, u_fast = run(True)
    close(y_fast.numpy(), y_gen.numpy(), atol=1e-6, rtol=1e-6)
    assert u_gen == u_fast
    for n in g_gen:
        close(g_fast[n].numpy(), g_gen[n].numpy(), atol=1e-6, rtol=1e-5)


# --- the rotation estimator ---------------------------------------------------

def test_rotate_to_value_and_gradient_match_jax():
    """``rotate_to``: the value is ``q``, and the gradient w.r.t. ``e`` is
    JAX's (lambda R^T v), on random rows and an antiparallel pair."""
    from ctvae_tpu.models.quantizers import rotate_to as jax_rotate_to
    from ctvae_torch.models.quantizers import rotate_to
    rng = np.random.default_rng(5)
    e, q, v = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    q[-1] = -2.0 * e[-1]                             # antiparallel
    want = jax_rotate_to(jnp.asarray(e), jnp.asarray(q))
    want_g = jax.grad(lambda e_: jnp.sum(jax_rotate_to(
        e_, jnp.asarray(q)) * jnp.asarray(v)))(jnp.asarray(e))
    te = torch.from_numpy(e).requires_grad_()
    got = rotate_to(te, torch.from_numpy(q))
    torch.sum(got * torch.from_numpy(v)).backward()
    close(t2n(got), np.asarray(want))
    close(t2n(got), q)
    close(te.grad.numpy(), np.asarray(want_g))


def test_rotation_quantizer_values_equal_ste():
    """The rotation estimator changes the gradient only: the quantizer's
    values and loss equal the straight-through estimator's."""
    from ctvae_torch.models import build_model
    x = torch.from_numpy(batch(3)[0])
    outs = []
    for est in ("ste", "rotation"):
        m = build_model(dict(MCQ, grad_estimator=est), device="cpu",
                        generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            outs.append(m.vq_layer(m.encoder(x)))
    close(t2n(outs[0][0]), t2n(outs[1][0]))
    close(t2n(outs[0][1]), t2n(outs[1][1]))


# --- the EMA codebook with revival --------------------------------------------

def _revived(vq_stats) -> list:
    """Per quantizer, how many codes the revival re-seeded (their count
    is set to exactly 1)."""
    return [int(np.sum(np.asarray(q["cluster_size"]) == 1.0))
            for _, q in sorted(vq_stats["vq_layer"].items())]


def test_ema_mcq_vae_train_step_matches_jax(monkeypatch):
    """MCQVAE(ema, revive_threshold, rotation): one train step against
    JAX: metrics, gradients, parameters and the EMA buffers against
    ``vq_stats``; the revival drew one ``randint`` per codebook and
    revived some codes, not all."""
    draws, tm, before, vq_stats = _check_step(
        monkeypatch, _mcq_pair(), "action", EXP, seed=23)
    assert [k for k, _ in draws] == ["randint", "randint"]
    assert all(0 < n < MCQ["num_embeddings"] for n in _revived(vq_stats))
    assert not list(tm.vq_layer.parameters())      # the codebook is no
    assert len(_buffers(tm)) == 3 * MCQ["codebooks"]   # parameter


@pytest.mark.parametrize("mode", MODES)
def test_multi_train_step_with_ema_equals_steps(mode):
    """``make_multi_train_step(mode, 2)`` twice equals four single steps
    from an equal state, the EMA buffers included, bit for bit."""
    _, _, tm = _pair(**CT_OPTIONS["endo-ema-ct_layer"][0])
    states = [tstate.create_train_state(
        m, topt.build_optimizers(EXP, m, 4), seed=3)
        for m in (copy.deepcopy(tm), copy.deepcopy(tm))]
    batches = [batch(40 + i) for i in range(4)]
    for x, y, a in batches:
        tstate.make_train_step(mode)(states[0], {
            "image": torch.from_numpy(x), "input_y": torch.from_numpy(y),
            "action": torch.from_numpy(a)})
    multi = tstate.make_multi_train_step(mode, 2)
    for half in (batches[:2], batches[2:]):
        multi(states[1], {k: torch.stack([torch.from_numpy(b[i])
                                          for b in half])
                          for i, k in enumerate(("image", "input_y",
                                                 "action"))})
    a, b = (s.state_dict() for s in states)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    assert set(a["model"]) == set(b["model"]) and any(
        n.endswith("cluster_size") for n in a["model"])
    for n, t in a["model"].items():
        assert torch.equal(t, b["model"][n]), n


def test_ema_buffers_stay_outside_the_optimizer_and_eval():
    """The buffers are in no optimizer; an eval step writes none of them;
    a train step writes them in place whatever ``update_parameters``
    trains."""
    _, _, tm0 = _pair(**CT_OPTIONS["endo-ema-ct_layer"][0])
    tm = copy.deepcopy(tm0)
    opt, = topt.build_optimizers(EXP_CT, tm, 4)
    ids = {id(p) for p in opt.params}
    assert not any(id(b) in ids for b in tm.buffers())
    state = tstate.create_train_state(tm, [opt], seed=1)
    x, y, a = map(torch.from_numpy, batch(9))
    b = {"image": x, "input_y": y, "action": a}
    held = {n: t for n, t in _buffers(tm).items()}
    before = {n: t.clone() for n, t in held.items()}
    for mode in MODES:
        tstate.make_eval_step(mode)(state, b)
    for n, t in _buffers(tm).items():
        assert torch.equal(t, before[n]), n
    tstate.make_train_step("base")(state, b)
    for n, t in _buffers(tm).items():
        assert t is held[n] and not torch.equal(t, before[n]), n


def _experiment(tmp, cfg, seed=3, async_save=False):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    data = VAEDataset("", dataset_name="TSynthetic", train_batch_size=8,
                      val_batch_size=8, patch_size=16, limit=24,
                      val_limit=8, seed=5)
    data.setup()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return VAEXperiment(model, dict(EXP), data, ckpt_manager=CheckpointManager(
        str(tmp), async_save=async_save))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoints_carry_ema_buffers(tmp_path, async_save):
    """A full-state resume (from a checkpoint written inline or on a
    thread) carries the EMA buffers and continues bit for bit; a
    weights-only restore loads the parameters alone, so a fresh model's
    buffers stay as initialised."""
    cfg = dict(SMALL, **EMA)
    straight = _experiment(tmp_path / "a", cfg)
    straight.fit(2, seed=11)
    first = _experiment(tmp_path / "b", cfg, async_save=async_save)
    first.fit(1, seed=11)
    trained = {n: t.clone() for n, t in _buffers(first.model).items()}
    resumed = _experiment(tmp_path / "b", cfg, seed=4, async_save=async_save)
    resumed.setup(seed=12)
    resumed.restore_full_state("last")
    for n, t in _buffers(resumed.model).items():
        assert torch.equal(t, trained[n]), n
    resumed.fit(2, seed=11)
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    for n, t in a["model"].items():
        assert torch.equal(t, b["model"][n]), n

    fresh = _experiment(tmp_path / "c", cfg, seed=5)
    fresh.setup(seed=1)
    init = {n: t.clone() for n, t in _buffers(fresh.model).items()}
    path = resumed.ckpt.path("last")
    saved = resumed.ckpt.restore(path)["model"]
    fresh.load_weights(path)
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, saved[n]), n
    for n, t in _buffers(fresh.model).items():
        assert torch.equal(t, init[n]) and not torch.equal(t, saved[n]), n


def test_from_jax_params_carries_vq_stats():
    """``vq_stats`` fills the EMA buffers by name; the params collection
    alone fills the parameters; a variables dict without ``vq_stats``
    leaves the buffers unfilled, which raises."""
    jm, variables, tm = _pair(**CT_OPTIONS["endo-ema-ct_layer"][0])
    variables = jax.device_get(variables)
    state = from_jax_params(variables, tm)
    assert set(state) == set(tm.state_dict())
    for i in range(SMALL["codebooks"]):
        jq = variables["vq_stats"]["vq_layer"][f"quantizers_{i}"]
        for leaf in ("embedding", "cluster_size", "embed_avg"):
            np.testing.assert_array_equal(
                state[f"vq_layer.quantizers_{i}.{leaf}"].numpy(),
                np.asarray(jq[leaf]))
    assert set(from_jax_params(variables["params"], tm)) == set(
        dict(tm.named_parameters()))
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_params({"params": variables["params"]}, tm)


def test_build_model_inits_ema_buffers_as_flax():
    """The EMA codebook drawn from U(-1/K, 1/K), ``embed_avg`` a copy of
    it, ``cluster_size`` zeros, as flax fills ``vq_stats``."""
    from ctvae_torch.models import build_model
    tm = build_model(dict(SMALL, **EMA), device="cpu")
    for q in tm.vq_layer.quantizers:
        K = q.num_embeddings
        assert float(q.embedding.abs().max()) <= 1.0 / K
        assert float(q.embedding.std()) > 0.2 / K
        assert torch.equal(q.embed_avg, q.embedding)
        assert not q.embedding.requires_grad
        assert torch.equal(q.cluster_size, torch.zeros(K))


# --- the registry: no field dropped -------------------------------------------

@pytest.mark.parametrize("name", ["CTMCQVAE", "MCQVAE"])
def test_model_fields_match_the_jax_dataclass(name):
    """Each port class takes every field of its JAX dataclass (flax's own
    ``parent`` / ``name`` aside), so ``build_model`` drops only keys JAX
    drops too; a YAML's ``ema_decay`` / ``revive_threshold`` reach the
    quantizers."""
    from ctvae_tpu.models import vae_models as jax_models
    from ctvae_torch.models import build_model, model_fields, vae_models
    want = set(jax_models[name].__dataclass_fields__) - {"parent", "name"}
    assert model_fields(vae_models[name]) == want
    cfg = dict(SMALL if name == "CTMCQVAE" else MCQ, ema=True,
               ema_decay=0.7, revive_threshold=0.25, kld_weight=0.1)
    tm = build_model(cfg, device="cpu")
    for q in tm.vq_layer.quantizers:
        assert (q.ema, q.ema_decay, q.revive_threshold) == (True, 0.7, 0.25)
