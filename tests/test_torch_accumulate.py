"""``accumulate_grad_batches`` under a multi-step train step: the port's
``make_multi_train_step`` against the JAX package's (``optax.MultiSteps``
inside the ``lax.scan``), a state saved and loaded in the middle of an
accumulation, and ``run.train`` with ``scan_steps`` and
``accumulate_grad_batches`` on ``configs/synthetic_ct.yaml``, all on the
CPU at small widths.

Tolerances, those of ``tests/test_torch_training.py``'s ``-k "multi or
scan"`` parity tests: the last step's metrics atol 1e-5 / rtol 1e-4,
``grad_norm`` rtol 1e-5, each step's gradient leaf 1e-5 x max(1, max |g|),
each parameter after the call n (2e-6 + LR / 1e-8 times the sum over the
steps of its gradient's difference) (``assert_steps_match``); the running
mean of an accumulation in progress 1e-5 x max(1, max |g|), as a gradient.
The port against itself (a load, ``scan_steps``) is bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctvae_torch.config import read_config
from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (ReplayDraws, assert_steps_match, batch,
                               build_pair, close, keep_step_grads,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0,
           gradient_clip_val=0.5)
N_STEPS = 4


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def _stacked(seeds):
    bs = [batch(s) for s in seeds]
    return {k: torch.from_numpy(np.stack([b[i] for b in bs]))
            for i, k in enumerate(("image", "input_y", "action"))}


def _jax_multi(jm, variables, mode, stacked, monkeypatch, seed, exp):
    """JAX's ``make_multi_train_step(n_steps=N_STEPS)``, jitted, its chain
    ``keep_step_grads`` then ``build_optimizers(exp)`` (``MultiSteps``
    under ``accumulate_grad_batches``). Returns (params, each step's raw
    gradients, the last metrics, the ``MultiSteps`` state, draws)."""
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    params = variables["params"]
    tx = optax.chain(keep_step_grads(N_STEPS),
                     jopt.build_optimizers(exp, params, 4)[0])
    state = jstate.TrainState(step=jnp.array(0, jnp.int32), params=params,
                              model_state={}, opt_states=(tx.init(params),),
                              rng=jax.random.PRNGKey(seed))
    step = jax.jit(jstate.make_multi_train_step(
        jm, [tx], n_steps=N_STEPS, M_N=1.0,
        fwd_kwargs_keys=("action", "input_y"),
        static_fwd_kwargs={"mode": mode}))
    with recorded_draws(monkeypatch, seed=seed) as rec:
        new, metrics = step(state, stacked)
    kept = jax.device_get(new.opt_states[0][0][1])
    grads = [jax.tree_util.tree_map(lambda g: g[i], kept)
             for i in range(N_STEPS)]
    return (jax.device_get(new.params), grads, jax.device_get(metrics),
            jax.device_get(new.opt_states[0][1]), rec.draws)


@pytest.mark.parametrize("k,mode", [(2, "base"), (3, "causal")])
def test_accumulating_multi_step_matches_jax(monkeypatch, pair, k, mode):
    """``make_multi_train_step(mode, 4)`` with ``accumulate_grad_batches``
    k against JAX's from the same parameters on the same four batches
    (JAX's draws, recorded while its scan body was traced, replayed four
    times): the last metrics, every step's gradients, the parameters after
    4 // k updates, the optimizer's update count against ``MultiSteps``'
    ``gradient_step`` and, at k = 3, the running mean of the one gradient
    accumulated toward the next update against ``acc_grads``."""
    jm, variables, tm0 = pair
    tm = copy.deepcopy(tm0)
    exp = dict(EXP, accumulate_grad_batches=k)
    stacked = _stacked((41, 42, 43, 44))
    j_params, j_grads, j_metrics, j_ms, draws = _jax_multi(
        jm, variables, mode, {n: jnp.asarray(v.numpy())
                              for n, v in stacked.items()},
        monkeypatch, seed=45, exp=exp)
    replay = ReplayDraws(draws * N_STEPS)
    monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
    grads, grads_of = [], tstate._grads

    def kept(state, b, m, *loss_args):
        out = grads_of(state, b, m, *loss_args)
        grads.append({n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).clone()
                      for n, p in state.model.named_parameters()})
        return out

    monkeypatch.setattr(tstate, "_grads", kept)
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm, 4))
    metrics = tstate.make_multi_train_step(mode, N_STEPS)(state, stacked)
    opt = state.optimizers[0]
    assert replay.done() and state.step == N_STEPS and len(grads) == N_STEPS
    assert opt.count == int(j_ms.gradient_step) == N_STEPS // k
    assert opt.mini_step == int(j_ms.mini_step) == N_STEPS % k
    assert set(metrics) == set(j_metrics)
    for name, v in j_metrics.items():
        close(t2n(metrics[name]), v)
    close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
          rtol=1e-5)
    assert_steps_match(tm, j_params, j_grads, grads, EXP["LR"])
    want = from_jax_params(j_ms.acc_grads, tm)
    names = [n for n, _ in tm.named_parameters()]
    for name, a in zip(names, opt.acc_buffers()):
        scale = max(1.0, float(want[name].abs().max()))
        close(t2n(a), want[name].numpy(), atol=1e-5 * scale, rtol=0)


def test_load_mid_accumulation_continues_it(pair):
    """A train state saved after 5 steps at ``accumulate_grad_batches`` 3
    (two gradients of the second update's three accumulated) and loaded
    into another model continues the accumulation: 4 more steps through
    ``make_multi_train_step(mode, 2)`` from it end, bit for bit, where 9
    steps of a run never saved end (parameters, Adam's moments, the mean's
    buffers, ``count``, ``mini_step``, generator)."""
    exp = dict(EXP, accumulate_grad_batches=3)
    stacked = _stacked(range(51, 60))
    part = [{k: v[i:i + 1] for k, v in stacked.items()} for i in range(5)]
    rest = [{k: v[i:i + 2] for k, v in stacked.items()} for i in (5, 7)]
    states = [tstate.create_train_state(
        m, topt.build_optimizers(exp, m, 4), seed=7)
        for m in (copy.deepcopy(pair[2]), copy.deepcopy(pair[2]))]
    one = tstate.make_multi_train_step("action", 1)
    for b in part:
        one(states[0], b)
    assert [states[0].optimizers[0].count,
            states[0].optimizers[0].mini_step] == [1, 2]
    saved = copy.deepcopy(states[0].state_dict())
    assert saved["optimizers"][0]["mini_step"] == 2
    assert saved["optimizers"][0]["acc"] is not None
    states[1].load_state_dict(saved)
    for s in states:
        two = tstate.make_multi_train_step("action", 2)
        for b in rest:
            two(s, b)
    a, b = states
    assert a.step == b.step == 9
    for oa, ob in zip(a.optimizers, b.optimizers):
        assert (oa.count, oa.mini_step) == (ob.count, ob.mini_step) == (3, 0)
        assert all(map(torch.equal, oa.acc_buffers(), ob.acc_buffers()))
        assert not any(t.any() for t in ob.acc_buffers())
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    for oa, ob in zip(a.optimizers, b.optimizers):
        for pa, pb in zip(oa.params, ob.params):
            for key, va in oa.adam.state[pa].items():
                assert torch.equal(va, ob.adam.state[pb][key]), key
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _synthetic_ct(save_dir, scan_steps, max_epochs=1, resume=None):
    """``configs/synthetic_ct.yaml`` with ``accumulate_grad_batches: 2`` and
    ``scan_steps``, at train batches of 3 of 16 rows a mode: 15 steps an
    epoch, the first epoch's schedule ``baccccbbaaabcba`` (one causal run
    of four), ending in the middle of an accumulation, and the second
    ``cbcaabaaacbcbbc``."""
    cfg = read_config(os.path.join(REPO, "configs", "synthetic_ct.yaml"))
    cfg["data_params"] = dict(cfg["data_params"], train_batch_size=3,
                              limit=16)
    cfg["exp_params"] = dict(cfg["exp_params"], scan_steps=scan_steps,
                             accumulate_grad_batches=2)
    cfg["trainer_params"] = dict(cfg["trainer_params"],
                                 max_epochs=max_epochs)
    if resume is not None:
        cfg["trainer_params"]["resume_from_checkpoint"] = resume
    cfg["logging_params"] = dict(cfg["logging_params"], save_dir=save_dir)
    return cfg


def _last(save_dir):
    [ver] = os.listdir(os.path.join(save_dir, "CTMCQVAE"))
    return os.path.join(save_dir, "CTMCQVAE", ver, "checkpoints", "last")


def test_run_train_scan_steps_with_accumulation(tmp_path, monkeypatch):
    """``run.train`` of ``configs/synthetic_ct.yaml`` with ``scan_steps: 4``
    and ``accumulate_grad_batches: 2`` (through a multi-step call) for one
    epoch, which ends in the middle of an accumulation, then a second
    epoch resumed from its ``last`` checkpoint, end where two epochs of
    ``scan_steps: 1`` in one run end, bit for bit: parameters and buffers,
    the step, the update count and the accumulation's state."""
    from ctvae_torch import run
    from ctvae_torch.training import experiment
    from ctvae_torch.utils.checkpoint import _load
    calls = []
    real = experiment.make_multi_train_step

    def counted(mode, n_steps, **kw):
        calls.append(n_steps)
        return real(mode, n_steps, **kw)
    monkeypatch.setattr(experiment, "make_multi_train_step", counted)
    four = str(tmp_path / "four")
    run.train(_synthetic_ct(four, 4), device="cpu")
    assert calls and set(calls) == {4}
    first = _load(_last(four))
    opt = first["optimizers"][0]
    assert first["step"] == 15 and opt["count"] == 7
    assert opt["mini_step"] == 1 and opt["acc"] is not None
    resumed, straight = str(tmp_path / "resumed"), str(tmp_path / "one")
    run.train(_synthetic_ct(resumed, 4, 2, resume=_last(four)),
              device="cpu")
    run.train(_synthetic_ct(straight, 1, 2), device="cpu")
    a, b = _load(_last(straight)), _load(_last(resumed))
    assert a["step"] == b["step"] == 30
    oa, ob = a["optimizers"][0], b["optimizers"][0]
    assert oa["count"] == ob["count"] == 15
    assert oa["mini_step"] == ob["mini_step"] == 0 and ob["acc"] is None
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
