"""The port's training slice against the JAX package at small widths:
one train step per CT mode (loss, every gradient leaf, ``grad_norm``, the
parameters after the optimizer), the eval step, the data layer, the
``chip_smoke.py`` configs and the CPU training entry point.

The JAX step is ``ctvae_tpu.training.state.make_train_step`` under
``jax.jit``, its optimizer chain prefixed by a transform that keeps the
raw gradients in the optimizer state (so one compiled step yields them);
its random draws, PE dropout included, are recorded and replayed into the
port (tests/torch_port_common.py). Only one step is compared: the CT model
amplifies f32 rounding by orders of magnitude per step
(tests/test_e2e_trajectory_parity.py), so trajectories are not.

Tolerances: loss and metrics atol 1e-5 / rtol 1e-4; each gradient leaf
abs 1e-5 x max(1, max |g|); ``grad_norm`` rtol 1e-5; each parameter after
the step 2e-6 plus LR / 1e-8 times its gradient's difference. Adam's first
step moves a parameter by LR g / (|g| + 1e-8), so a gradient that is
rounding noise on both sides (~1e-10, e.g. the GAT ``lin_r`` whose effect
a softmax cancels) moves it by a fraction of LR that differs between them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ctvae_tpu.training import optimizers as jopt
from ctvae_tpu.training import state as jstate
from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (ReplayDraws, batch, build_pair, close,
                               recorded_draws, t2n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0)
MODES = ("base", "action", "causal")


def _keep_grads():
    """An optax transform that passes updates on and keeps them as its
    state: the raw gradients of the step."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _jax_step(jm, variables, mode, b, monkeypatch, seed):
    params = variables["params"]
    tx = optax.chain(_keep_grads(), jopt.build_optimizers(EXP, params, 4)[0])
    state = jstate.TrainState(step=jnp.array(0, jnp.int32), params=params,
                              model_state={}, opt_states=(tx.init(params),),
                              rng=jax.random.PRNGKey(seed))
    step = jax.jit(jstate.make_train_step(
        jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
        static_fwd_kwargs={"mode": mode}))
    with recorded_draws(monkeypatch, seed=seed) as rec:
        new, metrics = step(state, b)
    return (jax.device_get(new.params), jax.device_get(new.opt_states[0][0]),
            jax.device_get(metrics), rec.draws)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(monkeypatch, pair, mode):
    jm, variables, tm0 = pair
    import copy
    tm = copy.deepcopy(tm0)
    x, y, a = batch(11)
    b = {"image": x, "input_y": y, "action": a}
    j_params, j_grads, j_metrics, draws = _jax_step(
        jm, variables, mode, {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=12)
    assert any(k == "bernoulli" for k, _ in draws)   # PE dropout ran
    replay = ReplayDraws(draws)
    monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    metrics = tstate.make_train_step(mode)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert replay.done() and state.step == 1

    for k in ("loss", "Reconstruction_Loss", "VQ_Loss", "CT_Loss"):
        close(t2n(metrics[k]), j_metrics[k])
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v)
    close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
          rtol=1e-5)

    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(1.0, float(want_g[name].abs().max()))
        close(t2n(g), want_g[name].numpy(), atol=1e-5 * scale, rtol=0)
        # Adam's first step moves p by LR g / (|g| + 1e-8), which changes
        # by at most LR / 1e-8 times a change of g: the gradients' own
        # difference bounds the parameters'
        tol = 2e-6 + EXP["LR"] / 1e-8 * (g - want_g[name]).abs()
        assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), name


def test_eval_step_matches_jax(monkeypatch, pair):
    jm, variables, tm = pair
    x, y, a = batch(13)
    b = {"image": x, "input_y": y, "action": a}
    step = jax.jit(jstate.make_eval_step(
        jm, M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
        static_fwd_kwargs={"mode": "causal"}))
    state = jstate.TrainState(step=jnp.array(0, jnp.int32),
                              params=variables["params"], model_state={},
                              opt_states=(), rng=jax.random.PRNGKey(0))
    with recorded_draws(monkeypatch, seed=14) as rec:
        want = jax.device_get(step(state, {k: jnp.asarray(v)
                                           for k, v in b.items()}))
    assert not any(k == "bernoulli" for k, _ in rec.draws)  # no dropout
    replay = ReplayDraws(rec.draws)
    monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
    got = tstate.make_eval_step("causal")(
        tstate.create_train_state(tm, []),
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert replay.done() and set(got) == set(want)
    for k, v in want.items():
        close(t2n(got[k]), v)
    assert all(p.grad is None for p in tm.parameters())


def test_from_jax_params_maps_gradient_and_updated_trees(pair):
    """Any tree shaped like ``params`` converts: a gradient tree and an
    updated parameter tree land on the same names in the port's layout."""
    jm, variables, tm = pair
    params = jax.device_get(variables["params"])
    grads = jax.tree_util.tree_map(lambda p: np.full_like(p, 2.0) * p,
                                   params)
    updated = jax.tree_util.tree_map(lambda p: p - 0.5, params)
    base = from_jax_params(params, tm)
    for tree, fn in ((grads, lambda t: 2.0 * t), (updated,
                                                  lambda t: t - 0.5)):
        got = from_jax_params(tree, tm)
        assert set(got) == set(base)
        for name, t in got.items():
            close(t.numpy(), fn(base[name]).numpy(), atol=1e-6, rtol=0)
    conv = "encoder.Conv_0.weight"
    assert got[conv].shape == tm.get_parameter(conv).shape


def test_train_step_freezes_outside_update_parameters(pair):
    """``update_parameters: ct_layer``: every other parameter is
    bit-unchanged, the ct_layer moves, and grad_norm still covers all."""
    import copy
    tm = copy.deepcopy(pair[2])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    exp = dict(EXP, update_parameters="ct_layer")
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm),
                                      seed=3)
    x, y, a = map(torch.from_numpy, batch(15))
    metrics = tstate.make_train_step("action")(
        state, {"image": x, "input_y": y, "action": a})
    moved = {n for n, p in tm.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved and all(n.startswith("ct_layer.") for n in moved)
    enc_grad = tm.encoder.Conv_0.weight.grad
    assert enc_grad is not None and enc_grad.any()
    assert float(metrics["grad_norm"]) > float(tstate.global_norm(
        p.grad for n, p in tm.named_parameters()
        if n.startswith("ct_layer.") and p.grad is not None))


# --- data layer ------------------------------------------------------------

def _datamodules(name="TSynthetic"):
    from ctvae_tpu.data.datamodule import VAEDataset as JVAEDataset
    from ctvae_torch.data import VAEDataset
    args = dict(dataset_name=name, train_batch_size=8, val_batch_size=8,
                patch_size=16, limit=24, val_limit=16, seed=5)
    jd = JVAEDataset("", distributed=False, **args)
    td = VAEDataset("", **args)
    jd.setup()
    td.setup()
    return jd, td


@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_transition_schedule_matches_jax(hosts):
    from ctvae_tpu.data.transition import TransitionBatchScheduler as JSched
    from ctvae_torch.data import TransitionBatchScheduler
    jd, td = _datamodules()
    host_id, num_hosts = hosts
    for shuffle, limit in ((True, 24), (False, None)):
        kw = dict(batch_size=4, shuffle=shuffle, limit=limit, seed=9,
                  host_id=host_id, num_hosts=num_hosts)
        js = JSched(jd.train_dataset, **kw)
        ts = TransitionBatchScheduler(td.train_dataset, **kw)
        assert ts.batches_per_epoch() == js.batches_per_epoch()
        for epoch in (0, 1):
            want = list(js.epoch(epoch))
            got = list(ts.epoch(epoch))
            assert [m for m, _ in got] == [m for m, _ in want]
            for (_, g), (_, w) in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,modes", [("TSynthetic", set(MODES)),
                                        ("Synthetic", {"base"})])
def test_datamodule_matches_jax(name, modes):
    jd, td = _datamodules(name)
    assert td.steps_per_epoch() == jd.steps_per_epoch()
    for loader in ("train_dataloader", "val_dataloader"):
        want = list(getattr(jd, loader)(1))
        got = list(getattr(td, loader)(1))
        assert len(got) == len(want) and len(got) > 0
        assert {b["mode"] for b in got} == modes
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["mode"] == w["mode"]
            for k in w:
                if k != "mode":
                    np.testing.assert_array_equal(g[k], w[k])


def test_other_datasets_not_ported():
    from ctvae_torch.data import VAEDataset
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VAEDataset("", dataset_name="TShapes3D")


# --- configs and the entry point -------------------------------------------

def test_chip_smoke_exp_params_match_yaml():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(REPO, "configs", "ct_mcq_vae.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert smoke.EXP_PARAMS == cfg["exp_params"]
    # the loop phase: the headline widths on TSynthetic (8 actions)
    assert smoke.LOOP_MODEL_PARAMS == {**cfg["model_params"],
                                       "action_dim": 8}


def test_run_trains_synthetic_ct_on_cpu():
    """``python -m ctvae_torch.run -c configs/synthetic_ct.yaml --device
    cpu``: one epoch of all three modes, finite metrics."""
    from ctvae_torch import run
    out = run.main(["-c", os.path.join(REPO, "configs", "synthetic_ct.yaml"),
                    "--device", "cpu"])
    assert {out[f"train_steps_{m}"] for m in MODES} == {3.0}
    assert all(np.isfinite(v) for v in out.values())
    assert "val_causal_acc" in out and "val_loss" in out


def test_unported_trainer_options_raise(pair):
    from ctvae_torch.training import VAEXperiment
    for extra in (dict(scan_steps=4), dict(sharding="fsdp"),
                  dict(metrics=["mig"])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            VAEXperiment(pair[2], {**EXP, **extra}, None)
