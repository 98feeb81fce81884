"""The model zoo's first members in the port against the JAX package at
small widths (img 16, hidden_dims [8, 16], latent 8, B = 4): the standard
backbone (ConvEncoder / ConvDecoder in train and eval mode, BatchNorm's
running statistics after two train passes), then per model (VanillaVAE,
VQVAE with ``ste`` / ``rotation`` / ``ema``, BetaVAE H and B on each side
of ``Capacity_max_iter``, LogCoshVAE, DIPVAE, InfoVAE, WAE_MMD imq and
rbf) the eval forward and ``loss_function`` at ``M_N``, one train step
(metrics, every gradient and parameter after Adam, BatchNorm's and the
EMA codebook's buffers) against ``ctvae_tpu.training.state.
make_train_step``, the eval step at ``M_N=1.0``; the registry's fields
and ``build_model``'s init ranges; the multi-step train step against
single steps; and the entry points: ``run.train`` of
``configs/synthetic_vae.yaml`` with ``kld_weight`` reaching the step, the
search CLI on ``configs_hyp/synthetic_hyp_search_asha.yaml``, and VQVAE's
missing prior (no ``sample`` entry point, no Samples grid).

Inputs come from numpy with a seed; JAX parameters cross through
``from_jax_params``; the reparameterisation normals, the MMD prior and
the EMA revival's ``randint`` are recorded on the JAX side and replayed
into the port (tests/torch_port_common.py). Tolerances: forward values
within 1e-5 of the output's largest magnitude; losses and metrics
rtol 1e-4; gradients within 1e-5 of their block's largest and parameters
after Adam as ``torch_port_common.assert_step_matches`` bounds them; buffers
atol 1e-5 / rtol 1e-4; port-only comparisons exact.
"""

import copy
import json
import math
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (ReplayDraws, close, jax_train_step_state,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, IMG = 4, 16
GAUSS = dict(in_channels=3, latent_dim=8, hidden_dims=[8, 16], img_size=IMG)
VQ = dict(name="VQVAE", in_channels=3, embedding_dim=8, num_embeddings=16,
          hidden_dims=[8, 16], img_size=IMG, beta=0.25)
EXP = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
M_N = 0.5
LOSS_RTOL = 1e-4

#: case -> (model_params, global step of the train step)
CASES = {
    "VanillaVAE": (dict(name="VanillaVAE", **GAUSS), 0),
    "VQVAE-ste": (VQ, 0),
    "VQVAE-rotation": (dict(VQ, grad_estimator="rotation"), 0),
    "VQVAE-ema": (dict(VQ, ema=True, ema_decay=0.9, revive_threshold=0.5),
                  0),
    "BetaVAE-H": (dict(name="BetaVAE", loss_type="H", beta=4.0, **GAUSS), 0),
    # C = 25 / 10 * (step + 1): 10 below Capacity_max_iter, clipped to 25
    # past it
    "BetaVAE-B-step3": (dict(name="BetaVAE", loss_type="B", gamma=10.0,
                             max_capacity=25, Capacity_max_iter=10,
                             **GAUSS), 3),
    "BetaVAE-B-step20": (dict(name="BetaVAE", loss_type="B", gamma=10.0,
                              max_capacity=25, Capacity_max_iter=10,
                              **GAUSS), 20),
    "LogCoshVAE": (dict(name="LogCoshVAE", alpha=10.0, beta=1.0, **GAUSS),
                   0),
    "DIPVAE": (dict(name="DIPVAE", lambda_diag=0.05, lambda_offdiag=0.1,
                    **GAUSS), 0),
    "InfoVAE": (dict(name="InfoVAE", reg_weight=110, kernel_type="imq",
                     alpha=-9.0, beta=10.5, **GAUSS), 0),
    "WAE_MMD-imq": (dict(name="WAE_MMD", reg_weight=100, kernel_type="imq",
                         **GAUSS), 0),
    "WAE_MMD-rbf": (dict(name="WAE_MMD", reg_weight=5000, kernel_type="rbf",
                         **GAUSS), 0),
}

_PAIRS = {}


def _images(seed: int, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        size=(n, IMG, IMG, 3)).astype(np.float32)


def _pair(case: str):
    """(JAX model, its variables, the port's model on the CPU with the
    JAX variables converted), built once per case."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    if case not in _PAIRS:
        cfg = CASES[case][0]
        jm = jax_build(dict(cfg))
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        variables = jax.device_get(jax.jit(
            lambda r, x: jm.init(r, x, train=False))(
            dict(zip(("params", "reparam", "noise"), keys)),
            jnp.asarray(_images(0, 2))))
        tm = build_model(dict(cfg), device="cpu")
        tm.load_state_dict(from_jax_params(variables, tm))
        _PAIRS[case] = (jm, variables, tm)
    jm, variables, tm = _PAIRS[case]
    return jm, variables, copy.deepcopy(tm)


def _close_scaled(got, want, rel=1e-5):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    want = np.asarray(want, np.float64)
    close(got, want, atol=rel * max(float(np.abs(want).max()), 1e-30),
          rtol=0)


def _jax_loss_kwargs(step, M_N, train):
    return dict(M_N=M_N, step=jnp.asarray(step, jnp.int32), train=train,
                optimizer_idx=0, rng=jax.random.PRNGKey(7))


# --- the standard backbone ----------------------------------------------------

def _backbone(kind: str):
    """(JAX module, its variables, the port's module, its input)."""
    from ctvae_tpu.models import backbones as jb
    from ctvae_torch.models import backbones as tb
    hd = (8, 16)
    rng = np.random.default_rng(3)
    if kind == "encoder":
        jmod, tmod = jb.ConvEncoder(hd), tb.ConvEncoder(3, hd)
        x = _images(3)
    else:
        jmod, tmod = jb.ConvDecoder(hd, out_channels=3), tb.ConvDecoder(hd, 3)
        x = rng.normal(size=(B, 4, 4, 16)).astype(np.float32)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x), train=False))
    tmod.load_state_dict(from_jax_params(variables, tmod))
    return jmod, variables, tmod, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_backbone_matches_jax(kind, train):
    """ConvEncoder / ConvDecoder (k3-s2 convs and transposed convs,
    BatchNorm, LeakyReLU, tanh) against flax's in eval mode (running
    statistics) and train mode (batch statistics)."""
    jmod, variables, tmod, x = _backbone(kind)
    want = jmod.apply(variables, jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    _close_scaled(t2n(tmod(torch.from_numpy(x), train=train)), want)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_batch_norm_running_statistics_match_flax(kind):
    """Two train passes on different batches: the running mean and the
    running variance follow flax (momentum 0.9, the biased batch
    variance: at the encoder's last block n = 64, where torch's unbiased
    one would be 1.6% larger); an eval pass writes none of them."""
    jmod, variables, tmod, x = _backbone(kind)
    rng = np.random.default_rng(5)
    inputs = [x, (x + rng.normal(size=x.shape) * 0.5).astype(np.float32)]
    state = dict(variables)
    for xi in inputs:
        _, mutated = jmod.apply(state, jnp.asarray(xi), train=True,
                                mutable=["batch_stats"])
        state = {**state, **jax.device_get(mutated)}
        tmod(torch.from_numpy(xi), train=True)
    before = {n: b.clone() for n, b in tmod.named_buffers()}
    tmod(torch.from_numpy(x), train=False)
    want = from_jax_params(state, tmod)
    names = [n for n, _ in tmod.named_buffers()]
    assert len(names) == 4 and all(n.endswith(("running_mean",
                                               "running_var"))
                                   for n in names)
    for n, b in tmod.named_buffers():
        assert torch.equal(b, before[n]), n
        close(t2n(b), want[n].numpy(), atol=1e-5, rtol=1e-4)
        assert not torch.equal(b, torch.zeros_like(b) if "mean" in n
                               else torch.ones_like(b)), n


# --- per model: forward and loss, train step, eval step -----------------------

@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_jax(case, monkeypatch):
    """The eval forward (running statistics, z = mu) and ``loss_function``
    at ``M_N`` = 0.5 and the case's step; the MMD prior's draw
    replayed."""
    jm, variables, tm = _pair(case)
    step = CASES[case][1]
    x = _images(21)
    with recorded_draws(monkeypatch, seed=4) as rec:
        j_out = jm.apply(variables, jnp.asarray(x), train=False)
        j_loss = jm.loss_function(j_out, **_jax_loss_kwargs(step, M_N,
                                                            False))
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=False, draws=replay)
        loss = tm.loss_function(out, M_N=M_N, step=torch.tensor(step),
                                train=False, optimizer_idx=0, draws=replay)
    assert replay.done()
    for k in ("recons", "mu", "log_var", "z"):
        if k in j_out:
            _close_scaled(t2n(out[k]), j_out[k])
    assert set(loss) == set(j_loss)
    for k, v in j_loss.items():
        close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)


def _block(name: str) -> str:
    """The block a parameter belongs to (``encoder.ConvBNBlock_0`` for
    ``encoder.ConvBNBlock_0.Conv_0.bias``)."""
    return name.rsplit(".", 2)[0]


def _assert_step_matches(tm, j_params, j_grads, lr):
    """``torch_port_common.assert_step_matches`` with each gradient's
    scale taken over its block: a conv bias right before a BatchNorm has
    a gradient of exactly zero in exact arithmetic (the normalisation
    removes the mean), so what both sides compute there is rounding
    noise of the block's own terms. Each gradient leaf within 1e-5 x
    max(1, the block's largest |g|) of JAX's, each parameter after Adam
    within 2e-6 + lr / 1e-8 times its gradient's difference."""
    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    scale = {}
    for name, g in want_g.items():
        b = _block(name)
        scale[b] = max(scale.get(b, 1.0), float(g.abs().max()))
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(t2n(g), want_g[name].numpy(),
              atol=1e-5 * scale[_block(name)], rtol=0)
        tol = 2e-6 + lr / 1e-8 * (g - want_g[name]).abs()
        assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), name


def _port_step(tm, b, draws, step, M_N_=M_N):
    replay = ReplayDraws(draws)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    state.step = step
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tstate, "Draws", lambda gen, device: replay)
        metrics = tstate.make_train_step("base", M_N=M_N_)(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert replay.done() and state.step == step + 1
    return metrics


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """One train step at ``M_N`` = 0.5 and the case's global step against
    the JAX step: every metric, ``grad_norm``, every gradient and every
    parameter after Adam, and the buffers the step writes (BatchNorm's
    ``batch_stats``, an EMA codebook's ``vq_stats``)."""
    jm, variables, tm = _pair(case)
    step = CASES[case][1]
    b = {"image": _images(11)}
    j_params, j_grads, j_metrics, draws, j_state = jax_train_step_state(
        jm, variables, "base", {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=12, exp=EXP, M_N=M_N, step=step)
    kinds = [k for k, _ in draws]
    if case.startswith(("VanillaVAE", "BetaVAE", "LogCosh", "DIP")):
        assert kinds == ["normal"]                  # the reparameterisation
    elif case == "InfoVAE":
        assert kinds == ["normal", "normal"]        # and the MMD prior
    elif case.startswith("WAE"):
        assert kinds == ["normal"]                  # the MMD prior alone
    before = {n: t.clone() for n, t in tm.named_buffers()}
    metrics = _port_step(tm, b, draws, step)
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    _assert_step_matches(tm, j_params, j_grads, EXP["LR"])
    want = from_jax_params({"params": j_params, **j_state}, tm)
    buffers = dict(tm.named_buffers())
    assert bool(buffers) == (case not in ("VQVAE-ste", "VQVAE-rotation"))
    assert all(not torch.equal(t, before[n]) for n, t in buffers.items())
    for n, t in buffers.items():
        close(t2n(t), want[n].numpy(), atol=1e-5, rtol=1e-4)


VQ_YAML_STEPS = 3


def test_vq_vae_yaml_steps_match_jax_at_full_width():
    """``configs/vq_vae.yaml`` as written (K = 512, hidden [128, 256],
    LR 0.005, ``kld_weight``) at B = 64 on Shapes3D stand-in images:
    VQ_YAML_STEPS train steps in JAX and in the port from the same
    converted weights and batches. The first step's metrics, gradients
    and parameters as ``test_train_step_matches_jax`` holds them; every
    later step's metrics within 1e-2: at this LR the VQ loss jumps
    (above 1e3 times the first step's by the third step, in JAX as in
    the port) and the first step's rounding grows with it, to about 6e-4
    after one step and 2e-3 after two."""
    import optax

    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    from ctvae_torch.config import read_config
    from ctvae_torch.data.standins import render_chunk
    from ctvae_torch.models import build_model
    from torch_port_common import keep_grads
    cfg = read_config(os.path.join(REPO, "configs", "vq_vae.yaml"))
    mp, exp = cfg["model_params"], cfg["exp_params"]
    n = 64
    factors = np.random.default_rng(0).integers(
        0, (10, 10, 10, 8, 4, 15), size=(VQ_YAML_STEPS * n, 6))
    images = (render_chunk(factors).astype(np.float32) / 255.0).reshape(
        VQ_YAML_STEPS, n, 64, 64, 3)
    jm = jax_build(dict(mp))
    variables = jax.device_get(jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(images[0, :2])))
    params = variables["params"]
    tx = optax.chain(keep_grads(), jopt.build_optimizers(exp, params, 100)[0])
    j_state = jstate.TrainState(step=jnp.array(0, jnp.int32), params=params,
                                model_state={}, opt_states=(tx.init(params),),
                                rng=jax.random.PRNGKey(1))
    j_step = jax.jit(jstate.make_train_step(
        jm, [tx], M_N=exp["kld_weight"], static_fwd_kwargs={"mode": "base"}))
    tm = build_model(dict(mp), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm, 100))
    step = tstate.make_train_step("base", M_N=exp["kld_weight"])
    curves = {"jax": [], "port": []}
    for i, x in enumerate(images):
        j_state, j_metrics = j_step(j_state, {"image": jnp.asarray(x)})
        j_metrics = jax.device_get(j_metrics)
        metrics = step(state, {"image": torch.from_numpy(x)})
        assert set(metrics) == set(j_metrics)
        curves["jax"].append({k: float(v) for k, v in j_metrics.items()})
        curves["port"].append({k: float(v) for k, v in metrics.items()})
        for k, v in j_metrics.items():
            close(t2n(metrics[k]), v, atol=1e-6,
                  rtol=LOSS_RTOL if i == 0 else 1e-2)
        if i == 0:
            _assert_step_matches(tm, jax.device_get(j_state.params),
                                 jax.device_get(j_state.opt_states[0][0]),
                                 exp["LR"])
    print(json.dumps({"vq_vae.yaml B=64 curves": curves}))
    for side in curves.values():
        assert side[-1]["VQ_Loss"] > 1e3 * side[0]["VQ_Loss"]


def test_beta_vae_capacity_follows_the_step():
    """BetaVAE B's capacity C = max_capacity / Capacity_max_iter * (step +
    1), clipped: the same outputs give losses that differ only through C,
    below Capacity_max_iter and past it, with ``step`` a Python int or a
    tensor."""
    _, _, tm = _pair("BetaVAE-B-step3")
    with torch.no_grad():
        out = tm(torch.from_numpy(_images(8)), train=False)
    kld = float(tm.loss_function(out, step=0)["KLD"])
    rec = float(tm.loss_function(out, step=0)["Reconstruction_Loss"])
    for step, C in ((3, 10.0), (20, 25.0), (torch.tensor(3), 10.0)):
        loss = float(tm.loss_function(out, M_N=M_N, step=step)["loss"])
        assert math.isclose(loss, rec + 10.0 * M_N * abs(kld - C),
                            rel_tol=1e-5)


@pytest.mark.parametrize("case", ["VanillaVAE", "InfoVAE", "VQVAE-ema"])
def test_eval_step_matches_jax(case, monkeypatch):
    """The eval step (``M_N=1.0``, running statistics, no buffer written)
    against JAX's ``make_eval_step``; InfoVAE's MMD prior replayed."""
    from ctvae_tpu.training import state as jstate
    jm, variables, tm = _pair(case)
    params = variables["params"]
    jstate_ = jstate.TrainState(
        step=jnp.array(0, jnp.int32), params=params,
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=(), rng=jax.random.PRNGKey(2))
    x = _images(31)
    with recorded_draws(monkeypatch, seed=9) as rec:
        want = jax.device_get(jax.jit(jstate.make_eval_step(
            jm, M_N=1.0, fwd_kwargs_keys=()))(jstate_,
                                              {"image": jnp.asarray(x)}))
    replay = ReplayDraws(rec.draws)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    before = {n: t.clone() for n, t in tm.named_buffers()}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tstate, "Draws", lambda gen, device: replay)
        got = tstate.make_eval_step("base")(state,
                                            {"image": torch.from_numpy(x)})
    assert replay.done() and set(got) == set(want)
    for k, v in want.items():
        close(t2n(got[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    for n, t in tm.named_buffers():
        assert torch.equal(t, before[n]), n


# --- the registry -------------------------------------------------------------

NEW_NAMES = ["VanillaVAE", "VQVAE", "BetaVAE", "LogCoshVAE", "DIPVAE",
             "InfoVAE", "WAE_MMD", "VAE", "GaussianVAE"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_fields_match_the_jax_dataclass(name):
    """Each new name maps to the JAX registry's class counterpart and
    takes every field of its dataclass; ``build_model`` drops only the
    keys JAX drops (``kld_weight`` here) and takes YAML lists."""
    from ctvae_tpu.models import vae_models as jax_models
    from ctvae_torch.models import build_model, model_fields, vae_models
    assert vae_models[name].__name__ == jax_models[name].__name__
    want = set(jax_models[name].__dataclass_fields__) - {"parent", "name"}
    assert model_fields(vae_models[name]) == want
    cfg = dict(VQ if name == "VQVAE" else GAUSS, name=name, kld_weight=0.1)
    tm = build_model(cfg, device="cpu")
    assert type(tm) is vae_models[name] and tm.device.type == "cpu"


def _fan_in(name, p):
    if p.dim() == 4:
        return (p.shape[0] if "ConvTranspose" in name else p.shape[1]) \
            * p.shape[2] * p.shape[3]
    return p.shape[1]


@pytest.mark.parametrize("name", ["VanillaVAE", "VQVAE", "BetaVAE",
                                  "LogCoshVAE", "DIPVAE", "InfoVAE",
                                  "WAE_MMD"])
def test_build_model_init_ranges(name):
    """At the zoo's default widths (img 64, latent 128): every conv and
    linear kernel has flax's ``lecun_normal`` spread (standard deviation
    1 / sqrt(fan_in) within 10%, nothing past two of them), biases are
    zero, a codebook is U(-1/K, 1/K), and BatchNorm starts at scale 1,
    bias 0, running mean 0 and running variance 1."""
    from ctvae_torch.models import build_model
    from ctvae_torch.models.backbones import BatchNorm
    tm = build_model({"name": name}, device="cpu").requires_grad_(False)
    bns = [m for m in tm.modules() if isinstance(m, BatchNorm)]
    assert (len(bns) == 10) == (name != "VQVAE") and (not bns) == (
        name == "VQVAE")
    for m in bns:
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
        assert torch.equal(m.running_mean, torch.zeros_like(m.bias))
        assert torch.equal(m.running_var, torch.ones_like(m.bias))
    bn_params = {id(p) for m in bns for p in m.parameters()}
    for n, p in tm.named_parameters():
        if id(p) in bn_params:
            continue
        if n.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), n
        elif n.endswith("embedding"):
            K = p.shape[0]
            assert float(p.abs().max()) <= 1.0 / K, n
            assert float(p.std()) > 0.5 / K, n
        else:
            std = 1.0 / math.sqrt(_fan_in(n, p))
            assert abs(float(p.std()) / std - 1.0) < 0.1, n
            assert float(p.abs().max()) <= 2.0 * std * 1.1369 + 1e-7, n


# --- the multi-step train step -------------------------------------------------

@pytest.mark.parametrize("case", ["VanillaVAE", "BetaVAE-B-step3"])
def test_multi_train_step_equals_steps(case):
    """``make_multi_train_step("base", 2, M_N=0.5)`` twice equals four
    single steps from an equal state: parameters, BatchNorm buffers,
    Adam's state, the generator and the step, bit for bit (BetaVAE B's
    capacity reads each step's own global step)."""
    _, _, tm = _pair(case)
    states = [tstate.create_train_state(
        m, topt.build_optimizers(EXP, m, 4), seed=3)
        for m in (copy.deepcopy(tm), copy.deepcopy(tm))]
    xs = [torch.from_numpy(_images(40 + i)) for i in range(4)]
    losses = [float(tstate.make_train_step("base", M_N=M_N)(
        states[0], {"image": x})["loss"]) for x in xs]
    multi = tstate.make_multi_train_step("base", 2, M_N=M_N)
    for half in (xs[:2], xs[2:]):
        last = multi(states[1], {"image": torch.stack(half)})
    assert float(last["loss"]) == losses[-1]
    a, b = (s.state_dict() for s in states)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    assert any(n.endswith("running_var") for n in a["model"])
    for n, t in a["model"].items():
        assert torch.equal(t, b["model"][n]), n
    for oa, ob in zip(a["optimizers"], b["optimizers"]):
        for p, st in oa["adam"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, ob["adam"]["state"][p][k]), (p, k)


# --- the entry points ---------------------------------------------------------

def test_run_train_synthetic_vae_passes_kld_weight(tmp_path, monkeypatch):
    """``run.train`` of ``configs/synthetic_vae.yaml`` (read by
    ``read_config``, logs under ``tmp_path``): two epochs on the CPU with
    finite metrics, checkpoints and the three grids; every train loss
    got ``M_N`` = the YAML's ``kld_weight`` and the global step, every
    validation loss ``M_N`` = 1.0."""
    from ctvae_torch import run
    from ctvae_torch.config import read_config
    from ctvae_torch.models import VanillaVAE
    cfg = read_config(os.path.join(REPO, "configs", "synthetic_vae.yaml"))
    cfg["logging_params"]["save_dir"] = str(tmp_path / "logs")
    seen = []
    orig = VanillaVAE.loss_function

    def spy(self, outputs, **kwargs):
        seen.append((kwargs["train"], kwargs["M_N"], int(kwargs["step"])))
        return orig(self, outputs, **kwargs)

    monkeypatch.setattr(VanillaVAE, "loss_function", spy)
    out = run.train(cfg, device="cpu")
    assert all(math.isfinite(v) for v in out.values())
    kld = cfg["exp_params"]["kld_weight"]
    train = [s for s in seen if s[0]]
    steps = 2 * int(out["train_steps_base"])
    assert steps > 0
    assert [(m, s) for _, m, s in train] == [(kld, s) for s in range(steps)]
    assert {m for t, m, _ in seen if not t} == {1.0}
    run_dir = tmp_path / "logs" / "VanillaVAE" / "version_0"
    assert (run_dir / "checkpoints" / "last").exists()
    for sub in ("Inputs", "Reconstructions", "Samples"):
        assert len(os.listdir(run_dir / sub)) == 2, sub


def test_vq_vae_has_no_sample_entry_point(tmp_path):
    """VQVAE has no prior: ``available_fns`` leaves out ``sample`` and
    ``make_inference_fn`` refuses it, while VanillaVAE serves it; a
    ``run.train`` of a VQVAE writes Inputs and Reconstructions grids and
    no Samples grid."""
    from ctvae_torch import run
    from ctvae_torch.models import build_model
    from ctvae_torch.serving.inference import (available_fns,
                                               make_inference_fn)
    vq = build_model(dict(VQ), device="cpu")
    vae = build_model(dict(name="VanillaVAE", **GAUSS), device="cpu")
    assert not hasattr(vq, "sample") and hasattr(vae, "sample")
    assert available_fns(vq) == ("reconstruct", "encode")
    assert available_fns(vae) == ("reconstruct", "encode", "sample")
    with pytest.raises(ValueError, match="unavailable"):
        make_inference_fn(vq, "sample")
    with pytest.raises(AttributeError):
        vq.sample(2)
    assert make_inference_fn(vae, "sample", num_samples=3)(
        generator=torch.Generator().manual_seed(0)).shape == (3, IMG, IMG, 3)
    x = torch.from_numpy(_images(2))
    assert make_inference_fn(vq, "reconstruct")(x).shape == x.shape
    assert make_inference_fn(vq, "encode")(x).shape == (B, 4 * 4 * 8)
    cfg = {"model_params": dict(VQ),
           "data_params": dict(dataset_name="Synthetic", train_batch_size=8,
                               val_batch_size=8, patch_size=IMG, n=96),
           "exp_params": dict(EXP, kld_weight=0.00025, manual_seed=1),
           "trainer_params": {"max_epochs": 1},
           "logging_params": {"save_dir": str(tmp_path), "name": "VQVAE"}}
    out = run.train(cfg, device="cpu")
    assert math.isfinite(out["val_loss"])
    run_dir = tmp_path / "VQVAE" / "version_0"
    assert len(os.listdir(run_dir / "Inputs")) == 1
    assert len(os.listdir(run_dir / "Reconstructions")) == 1
    assert os.listdir(run_dir / "Samples") == []


def test_search_cli_on_the_vanilla_vae_asha_config(tmp_path, monkeypatch,
                                                   capsys):
    """``python -m ctvae_torch.hyperparameter_search`` on
    ``configs_hyp/synthetic_hyp_search_asha.yaml`` (VanillaVAE), cut to 3
    trials, 2 epochs and 256 images, with PyYAML blocked: exit 0, the
    root script's trial parameters, every loss finite, the best the
    minimum, and the survivor trained both epochs."""
    import yaml

    import hyperparameter_search as root_hs
    from ctvae_torch import hyperparameter_search as hs
    from ctvae_torch.config import read_config
    cfg = read_config(os.path.join(REPO, "configs_hyp",
                                   "synthetic_hyp_search_asha.yaml"))
    cfg["logging_params"]["save_dir"] = str(tmp_path / "logs")
    cfg["trainer_params"]["max_epochs"] = 2
    cfg["data_params"]["n"] = 256
    cfg["hyperparameter_search"].update(num_samples=3, reduction_factor=2)
    path = tmp_path / "hyp.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    with open(path) as f:
        root_cfg = yaml.full_load(f)
    hyp = root_cfg.pop("hyperparameter_search")
    rng = random.Random(int(root_cfg["exp_params"]["manual_seed"]))
    want = [root_hs._searched(root_hs.sample_params(root_cfg, hyp["params"],
                                                    rng), hyp["params"])
            for _ in range(3)]
    monkeypatch.setitem(sys.modules, "yaml", None)
    code = hs.main(["-c", str(path), "--device", "cpu"])
    with open(tmp_path / "logs" / "VanillaVAE" / "hyp_search"
              / "results.json") as f:
        results = json.load(f)
    assert code == 0
    trials = sorted(results["trials"], key=lambda t: t["trial"])
    assert [t["params"] for t in trials] == want
    assert all(math.isfinite(t["loss"]) for t in trials)
    assert results["best"]["loss"] == min(t["loss"] for t in trials)
    out = capsys.readouterr().out
    survivor = int(out.split("asha survivors (best first): [")[1][0])
    assert out.count(f"trial {survivor}: val_Reconstruction_Loss") == 2

