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
import pytest
import torch
import yaml

from ctvae_tpu.training import state as jstate
from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (SMALL, ReplayDraws, assert_step_matches,
                               assert_steps_match, batch, build_pair, close,
                               jax_multi_train_step, jax_train_step,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0)
MODES = ("base", "action", "causal")


# SMALL at img 32: two downsamplings leave 8 x 8, so the two codebooks
# give S = 128 latent sites and the GAT S + 1 = 129 nodes, past S = T =
# 120, the most the port's pairwise backward kernel once took
SITES_128 = dict(SMALL, img_size=32)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(scope="module")
def pair_128():
    return build_pair(SITES_128, seed=0)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(monkeypatch, pair, mode):
    _check_train_step(monkeypatch, pair, mode, SMALL)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax_past_120_sites(monkeypatch, pair_128, mode):
    """One train step per mode of the CT model with S = 128 sites against
    JAX: the shape class the card's backward kernels take since dout is
    read from device memory above S = T = 120 (pairwise) and the GAT's
    scratch rows lie over its dout tile above 124 nodes."""
    tm = pair_128[2]
    assert tm.nb_latents ** 2 * SITES_128["codebooks"] == 128
    _check_train_step(monkeypatch, pair_128, mode, SITES_128)


def _check_train_step(monkeypatch, pair, mode, cfg):
    """One ``make_train_step`` of ``mode`` in the port and in JAX from the
    same params and draws: metrics, ``grad_norm``, every gradient leaf and
    every parameter after the optimizer."""
    jm, variables, tm0 = pair
    import copy
    tm = copy.deepcopy(tm0)
    x, y, a = batch(11, cfg=cfg)
    b = {"image": x, "input_y": y, "action": a}
    j_params, j_grads, j_metrics, draws = jax_train_step(
        jm, variables, mode, {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=12, exp=EXP)
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
    assert_step_matches(tm, j_params, j_grads, EXP["LR"])


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


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """A CelebA stand-in of 24 images written by the port (its split 80 /
    10 / 10, attributes and transitions) and 4 OxfordPets JPEGs."""
    from ctvae_torch import native
    from ctvae_torch.data.standins import (ensure_celeba_standin,
                                           label_celeba_standin,
                                           render_celeba_images)
    from ctvae_torch.data.variations import generate_celeba
    root = str(tmp_path_factory.mktemp("jpeg"))
    ensure_celeba_standin(root, 24, verbose=False)
    label_celeba_standin(root, 24)
    generate_celeba(root)
    pets = os.path.join(root, "OxfordPets", "images")
    os.makedirs(pets)
    native.codec().encode_batch(render_celeba_images(range(4)), [
        os.path.join(pets, f"pet_{i}.jpg") for i in range(4)])
    return root


@pytest.mark.parametrize("name", ["TCeleba", "OxfordPets", "Celeba"])
def test_jpeg_datasets_are_registered(name, jpeg_root):
    """Each JPEG dataset builds a data module on the port's fixture whose
    first train batch has images of the patch size (the parity with JAX:
    tests/test_torch_celeba.py)."""
    from ctvae_torch.data import VAEDataset
    data = VAEDataset(jpeg_root, dataset_name=name, train_batch_size=2,
                      val_batch_size=2, patch_size=32, limit=4)
    data.setup()
    batch = next(iter(data.train_dataloader(0)))
    assert batch["image"].shape == (2, 32, 32, 3)
    assert batch["labels"].shape == ((2,) if name == "OxfordPets"
                                     else (2, 40))


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


def test_run_trains_synthetic_ct_on_cpu(tmp_path, monkeypatch):
    """``python -m ctvae_torch.run -c configs/synthetic_ct.yaml --device
    cpu``: one epoch of all three modes, finite metrics, checkpoints under
    ``logs/<name>/version_0/checkpoints`` (the config's relative
    ``save_dir``, here below a temporary working directory)."""
    from ctvae_torch import run
    monkeypatch.chdir(tmp_path)
    out = run.main(["-c", os.path.join(REPO, "configs", "synthetic_ct.yaml"),
                    "--device", "cpu"])
    assert {out[f"train_steps_{m}"] for m in MODES} == {3.0}
    assert all(np.isfinite(v) for v in out.values())
    assert "val_causal_acc" in out and "val_loss" in out
    ckpts = tmp_path / "logs" / "CTMCQVAE" / "version_0" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["index.json", "last", "step_9"]


def test_unported_trainer_options_raise(pair):
    """FSDP, sequence parallelism and ``model_axis`` > 1 are not ported
    (ROADMAP A8); ``dcn_replicas`` is (data parallelism), but a single
    process has no world for two replicas to divide."""
    from ctvae_torch.training import VAEXperiment
    for extra in (dict(sharding="fsdp"), dict(sharding="sp"),
                  dict(model_axis=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            VAEXperiment(pair[2], {**EXP, **extra}, None)
    exp = VAEXperiment(pair[2], {**EXP, "dcn_replicas": 2}, None)
    with pytest.raises(ValueError, match="dcn_replicas 2"):
        exp.setup()


# --- the multi-step train step and exp_params.scan_steps -------------------

def _adam_tensors(state):
    """Every tensor of every optimizer's Adam state, in a fixed order."""
    out = []
    for opt in state.optimizers:
        adam = opt.adam.state_dict()["state"]
        out += [adam[i][k] for i in sorted(adam) for k in sorted(adam[i])]
    return out


def _stacked(seeds, cfg=SMALL):
    """The batches of ``seeds``, one dict of [n, B, ...] tensors."""
    bs = [batch(s, cfg=cfg) for s in seeds]
    return {k: torch.from_numpy(np.stack([b[i] for b in bs]))
            for i, k in enumerate(("image", "input_y", "action"))}


@pytest.mark.parametrize("mode", MODES)
def test_multi_train_step_equals_steps_on_cpu(pair, mode):
    """On the CPU ``make_multi_train_step(mode, 3)`` over 3 stacked
    batches is 3 calls of ``make_train_step(mode)``: the same parameters,
    Adam state, generator state, step and last metrics, bit for bit."""
    import copy
    stacked = _stacked((21, 22, 23))
    states = [tstate.create_train_state(
        m, topt.build_optimizers(EXP, m, 4), seed=7)
        for m in (copy.deepcopy(pair[2]), copy.deepcopy(pair[2]))]
    step = tstate.make_train_step(mode)
    for i in range(3):
        want = step(states[0], {k: v[i] for k, v in stacked.items()})
    got = tstate.make_multi_train_step(mode, 3)(states[1], stacked)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert states[0].step == states[1].step == 3
    assert [o.count for o in states[1].optimizers] == [3]
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    a, b = _adam_tensors(states[0]), _adam_tensors(states[1])
    assert len(a) == len(b) > 0 and all(map(torch.equal, a, b))
    assert torch.equal(states[0].generator.get_state(),
                       states[1].generator.get_state())


def test_multi_train_step_rejects_unstacked_batches(pair):
    state = tstate.create_train_state(pair[2], [])
    x, y, a = map(torch.from_numpy, batch(24))
    with pytest.raises(ValueError, match="stacked"):
        tstate.make_multi_train_step("base", 2)(
            state, {"image": x, "input_y": y, "action": a})


def test_optimizer_load_takes_this_devices_adam_form(pair):
    """A train state saved with Adam in its capturable form (as the card
    saves it) resumes on the CPU in the host form, and the run goes on as
    one that was never saved, bit for bit."""
    import copy
    stacked = _stacked((31, 32))
    states = [tstate.create_train_state(
        m, topt.build_optimizers(EXP, m, 4), seed=7)
        for m in (copy.deepcopy(pair[2]), copy.deepcopy(pair[2]))]
    step = tstate.make_train_step("action")
    step(states[0], {k: v[0] for k, v in stacked.items()})
    saved = copy.deepcopy(states[0].state_dict())
    for group in saved["optimizers"][0]["adam"]["param_groups"]:
        group["capturable"] = True
    states[1].load_state_dict(saved)
    adam = states[1].optimizers[0].adam
    assert [g["capturable"] for g in adam.param_groups] == [False]
    assert all(st["step"].device.type == "cpu"
               for st in adam.state.values())
    for s in states:
        step(s, {k: v[1] for k, v in stacked.items()})
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    a, b = _adam_tensors(states[0]), _adam_tensors(states[1])
    assert len(a) == len(b) > 0 and all(map(torch.equal, a, b))


@pytest.mark.parametrize("mode", MODES)
def test_multi_train_step_matches_jax(monkeypatch, pair, mode):
    """The port's 3-step call against
    ``ctvae_tpu.training.state.make_multi_train_step(n_steps=3)`` from the
    same params on the same three batches, the draws recorded while JAX
    traced its scan body (the same draws each step) replayed three times:
    the last step's metrics (ATOL 1e-5, RTOL 1e-4) and ``grad_norm``, each
    step's gradients and the parameters after the third update
    (``assert_steps_match``: ``assert_step_matches``' limits over three
    updates; the GAT ``lin_r`` gradients that a softmax cancels are
    rounding noise on both sides, ~1e-9, and move their parameters by a
    share of LR that differs at every update)."""
    import copy
    jm, variables, tm0 = pair
    tm = copy.deepcopy(tm0)
    stacked = _stacked((31, 32, 33))
    j_params, j_grads, j_metrics, draws = jax_multi_train_step(
        jm, variables, mode, {k: jnp.asarray(v.numpy())
                              for k, v in stacked.items()},
        monkeypatch, seed=34, exp=EXP, n_steps=3)
    replay = ReplayDraws(draws * 3)
    monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
    grads, grads_of = [], tstate._grads

    def kept(state, b, m, *loss_args):
        out = grads_of(state, b, m, *loss_args)
        grads.append({n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).clone()
                      for n, p in state.model.named_parameters()})
        return out

    monkeypatch.setattr(tstate, "_grads", kept)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    metrics = tstate.make_multi_train_step(mode, 3)(state, stacked)
    assert replay.done() and state.step == 3 and len(grads) == 3
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v)
    close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
          rtol=1e-5)
    assert_steps_match(tm, j_params, j_grads, grads, EXP["LR"])


def _scan_experiment(pair, scan_steps, calls):
    """A ``VAEXperiment`` of the small model on TSynthetic (batches of 4,
    limit 40: a run of four causal batches, then shorter runs) after one
    train epoch, counting its multi-step calls in ``calls``."""
    import copy

    from ctvae_torch.data import VAEDataset
    from ctvae_torch.training import VAEXperiment
    data = VAEDataset("", dataset_name="TSynthetic", train_batch_size=4,
                      val_batch_size=4, patch_size=16, limit=40,
                      val_limit=8, seed=5)
    data.setup()
    exp = VAEXperiment(copy.deepcopy(pair[2]),
                       dict(EXP, scan_steps=scan_steps), data)
    exp.setup(seed=3)
    multi = exp._multi_train_step

    def counted(mode):
        step = multi(mode)

        def call(state, batches):
            calls.append((mode, int(batches["image"].shape[0])))
            return step(state, batches)
        return call

    exp._multi_train_step = counted
    return exp, exp.train_epoch(0)


def test_scan_steps_epoch_equals_per_step(pair):
    """``exp_params.scan_steps: 4`` ends a train epoch in the state that
    ``scan_steps: 1`` leaves, bit for bit (parameters, Adam state, step,
    generator, the last batch's metrics), over a schedule with a block of
    four, mode switches and short remainders run step by step."""
    calls_1, calls_4 = [], []
    exp_1, out_1 = _scan_experiment(pair, 1, calls_1)
    exp_4, out_4 = _scan_experiment(pair, 4, calls_4)
    assert calls_1 == [] and calls_4 == [("causal", 4)]
    assert exp_1.global_step == exp_4.global_step == 30
    assert exp_4.state.step == 30
    for k in out_1:
        if k != "images_per_sec":
            assert out_4[k] == out_1[k], k
    s1, s4 = exp_1.state, exp_4.state
    for p, q in zip(s1.model.parameters(), s4.model.parameters()):
        assert torch.equal(p, q)
    assert all(map(torch.equal, _adam_tensors(s1), _adam_tensors(s4)))
    assert torch.equal(s1.generator.get_state(), s4.generator.get_state())
