"""The rest of the Gaussian zoo in the port against the JAX package at small
widths (img 16, hidden_dims [8, 16], latent 8, B = 4; BetaTCVAE hidden
[8, 8]; LVAE latent_dims [4, 8]; CategoricalVAE 4 x 5 categories; IWAE
S = 3; MIWAE M = 2, S = 3): per model (IWAE, MIWAE, SWAE with ``normal``
and ``cauchy`` projections, BetaTCVAE, CategoricalVAE at step 0 and past
``anneal_interval``, JointVAE, GammaVAE, VampVAE, HVAE, LVAE) the eval
forward and ``loss_function`` at ``M_N``, one train step (metrics, every
gradient and parameter after Adam, BatchNorm's buffers: VampVAE's after
its two encoder passes) against ``ctvae_tpu.training.state.
make_train_step`` with the kinds and order of its draws asserted, and the
eval step; the registry's fields and the ``GumbelVAE`` alias;
``build_model``'s init ranges (GammaVAE's heads orthogonal); the
converter on a ConvTranspose and a BatchNorm whose flax names carry no
type; serving (HVAE's drawing ``encode``, LVAE's nested one, IWAE's
5-D ``reconstruct``) against ``ctvae_tpu.serving.export``; ``run.train``
writing all three grids for IWAE and LVAE; and each of the ten
``configs/`` YAMLs at full width, forward and loss against JAX at B = 2.

Inputs come from numpy with a seed; JAX parameters cross through
``from_jax_params``; every draw (normals, uniforms, randints, cauchys and
per-element gammas) is recorded on the JAX side and replayed into the
port (tests/torch_port_common.py), and each test asserts
``ReplayDraws.done()``. Tolerances, those of tests/test_torch_zoo.py:
forward values within 1e-5 of the output's largest magnitude; losses and
metrics rtol 1e-4 (atol 1e-6); gradients within 1e-5 of their block's
largest and parameters after Adam as ``torch_port_common.
assert_step_matches`` bounds them; buffers atol 1e-5 / rtol 1e-4.
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from test_torch_zoo import (EXP, LOSS_RTOL, M_N, _assert_step_matches,
                            _close_scaled, _jax_loss_kwargs, _port_step)
from torch_port_common import (ReplayDraws, close, jax_train_step_state,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, IMG = 4, 16
GAUSS = dict(in_channels=3, latent_dim=8, hidden_dims=[8, 16], img_size=IMG)
SMALL = dict(in_channels=3, hidden_dims=[8, 16], img_size=IMG)
CAT = dict(name="CategoricalVAE", latent_dim=4, categorical_dim=5,
           alpha=30.0, temperature=0.5, anneal_interval=2, **SMALL)
SWAE = dict(name="SWAE", reg_weight=100, wasserstein_deg=2.0,
            num_projections=6, **GAUSS)

#: case -> (model_params, global step, the draws of a train step in order)
CASES = {
    "IWAE": (dict(name="IWAE", num_samples=3, **GAUSS), 0,
             [("normal", (B, 3, 8))]),
    "MIWAE": (dict(name="MIWAE", num_samples=3, num_estimates=2, **GAUSS),
              0, [("normal", (B, 2, 3, 8))]),
    # the prior's normal, then the projections
    "SWAE-normal": (dict(SWAE, projection_dist="normal"), 0,
                    [("normal", (B, 8)), ("normal", (6, 8))]),
    "SWAE-cauchy": (dict(SWAE, projection_dist="cauchy"), 0,
                    [("normal", (B, 8)), ("cauchy", (6, 8))]),
    # anneal (step + 1) / 10 = 0.4 under train
    "BetaTCVAE": (dict(name="BetaTCVAE", in_channels=3, latent_dim=8,
                       hidden_dims=[8, 8], img_size=IMG, anneal_steps=10,
                       alpha=1.0, beta=6.0, gamma=1.0), 3,
                  [("normal", (B, 8))]),
    "CategoricalVAE-step0": (dict(CAT, anneal_rate=3e-5), 0,
                             [("uniform", (B, 4, 5))]),
    # a negative rate lifts the temperature above its clamp, so the
    # forward's tau = 0.5 exp(0.1 * 4) at step 5 (interval 2) reads the
    # step the train step passes: the reference's positive rate leaves
    # tau at the clamp whatever the step
    "CategoricalVAE-step5": (dict(CAT, anneal_rate=-0.1), 5,
                             [("uniform", (B, 4, 5))]),
    # the capacities (step + 1) * 5 / 10 = 2 below their max
    "JointVAE": (dict(name="JointVAE", categorical_dim=5,
                      latent_max_capacity=5.0, latent_num_iter=10,
                      categorical_max_capacity=5.0, categorical_num_iter=10,
                      latent_gamma=10.0, categorical_gamma=10.0, alpha=10.0,
                      **GAUSS), 3,
                 [("normal", (B, 8)), ("uniform", (B, 5))]),
    "GammaVAE": (dict(name="GammaVAE", latent_dim=8, gamma_shape=8.0,
                      prior_shape=2.0, prior_rate=1.0, **SMALL), 0,
                 [("gamma", (B, 8))]),
    "VampVAE": (dict(name="VampVAE", num_components=5, **GAUSS), 0,
                [("normal", (B, 8))]),
    # z2 in encode, then z1
    "HVAE": (dict(name="HVAE", latent1_dim=8, latent2_dim=6, **SMALL), 0,
             [("normal", (B, 6)), ("normal", (B, 8))]),
    # one normal per rung, top rung first
    "LVAE": (dict(name="LVAE", in_channels=3, latent_dims=[4, 8],
                  hidden_dims=[8, 16], img_size=IMG), 0,
             [("normal", (B, 8)), ("normal", (B, 4))]),
}

#: the draws of the eval forward and loss where they differ from the train
#: step's (the reparameterisation off outside train)
EVAL_DRAWS = {"BetaTCVAE": [], "VampVAE": []}

_PAIRS = {}


def _images(seed: int, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        size=(n, IMG, IMG, 3)).astype(np.float32)


def _jax_init(jm, x):
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    return jax.device_get(jax.jit(lambda r, x: jm.init(r, x, train=False))(
        dict(zip(("params", "reparam", "gumbel", "noise", "dropout"), keys)),
        jnp.asarray(x)))


def _full_width_variables(jm, x, seed: int = 0):
    """Variables of the tree ``jm.init`` would make (``eval_shape``: no
    init is run, which at full width costs seconds on the CPU), filled
    from numpy: kernels normal with variance 1 / fan-in (flax's
    ``lecun_normal`` but for its truncation), biases and running means
    zero, scales and running variances one."""
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            dict(zip(("params", "reparam", "gumbel", "noise",
                                      "dropout"),
                                     jax.random.split(jax.random.PRNGKey(0),
                                                      5))),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, fan ** -0.5, s.shape).astype(np.float32)
        return np.full(s.shape, 1.0 if leaf in ("scale", "var") else 0.0,
                       np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rngs():
    """The forward's streams (the recorder replaces what they draw)."""
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    return dict(zip(("reparam", "gumbel", "noise", "dropout"), keys))


def _pair(case: str):
    """(JAX model, its variables, the port's model on the CPU with the
    JAX variables converted), built once per case."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    if case not in _PAIRS:
        cfg = CASES[case][0]
        jm = jax_build(dict(cfg))
        variables = _jax_init(jm, _images(0, 2))
        tm = build_model(dict(cfg), device="cpu")
        tm.load_state_dict(from_jax_params(variables, tm))
        _PAIRS[case] = (jm, variables, tm)
    jm, variables, tm = _PAIRS[case]
    return jm, variables, copy.deepcopy(tm)


def _kinds(draws):
    return [(k, tuple(getattr(a, "shape", ()))) for k, a in draws]


def _compare_outputs(out, j_out):
    assert set(out) == set(j_out)
    for k, v in j_out.items():
        if k == "input":
            continue
        _close_scaled(t2n(out[k]), v)


# --- per model: forward and loss, train step, eval step ----------------------

@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_jax(case, monkeypatch):
    """The eval forward (running statistics; the reparameterisation, the
    Gumbel noise and the gamma draw where the model draws in eval too)
    and ``loss_function`` at ``M_N`` = 0.5 and the case's step, every
    output of the forward and every loss term; the draws' kinds and
    order asserted."""
    jm, variables, tm = _pair(case)
    _, step, train_draws = CASES[case]
    x = _images(21)
    with recorded_draws(monkeypatch, seed=4) as rec:
        j_out = jm.apply(variables, jnp.asarray(x), train=False,
                         rngs=_rngs(), step=jnp.asarray(step, jnp.int32))
        j_loss = jm.loss_function(j_out, **_jax_loss_kwargs(step, M_N,
                                                            False))
    # dispatch is asynchronous: a gamma slot is filled when JAX has run
    j_out, j_loss = jax.device_get((j_out, j_loss))
    assert _kinds(rec.draws) == EVAL_DRAWS.get(case, train_draws)
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=False, draws=replay,
                 step=torch.tensor(step))
        loss = tm.loss_function(out, M_N=M_N, step=torch.tensor(step),
                                train=False, optimizer_idx=0, draws=replay)
    assert replay.done()
    _compare_outputs(out, j_out)
    assert set(loss) == set(j_loss)
    for k, v in j_loss.items():
        close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """One train step at ``M_N`` = 0.5 and the case's global step (passed
    to the forward and to the loss) against the JAX step: the draws'
    kinds and order, every metric, ``grad_norm``, every gradient and
    every parameter after Adam, and BatchNorm's running statistics
    (VampVAE's encoder's after the batch's pass and the pseudo-inputs')."""
    jm, variables, tm = _pair(case)
    _, step, kinds = CASES[case]
    b = {"image": _images(11)}
    j_params, j_grads, j_metrics, draws, j_state = jax_train_step_state(
        jm, variables, "base", {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=12, exp=EXP, M_N=M_N, step=step)
    assert _kinds(draws) == kinds
    before = {n: t.clone() for n, t in tm.named_buffers()}
    metrics = _port_step(tm, b, draws, step)
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v, atol=1e-6, rtol=LOSS_RTOL)
    _assert_step_matches(tm, j_params, j_grads, EXP["LR"])
    want = from_jax_params({"params": j_params, **j_state}, tm)
    buffers = dict(tm.named_buffers())
    assert bool(buffers) == (case != "BetaTCVAE")
    assert all(not torch.equal(t, before[n]) for n, t in buffers.items())
    for n, t in buffers.items():
        close(t2n(t), want[n].numpy(), atol=1e-5, rtol=1e-4)


def test_vamp_vae_buffers_take_both_encoder_passes():
    """VampVAE's train forward runs the encoder on the batch, then on the
    pseudo-images: each encoder BatchNorm's running mean is the momentum
    fold of the batch's statistics, then the pseudo-images' (flax's order);
    a decoder BatchNorm's takes one pass."""
    from ctvae_torch.models.base import Draws
    _, _, tm = _pair("VampVAE")
    x = torch.from_numpy(_images(13))
    bn = tm.encoder.ConvBNBlock_0.BatchNorm_0
    dec_bn = tm.decoder.DeconvBNBlock_0.BatchNorm_0
    conv = tm.encoder.ConvBNBlock_0.Conv_0
    r0, d0 = bn.running_mean.clone(), dec_bn.running_mean.clone()
    with torch.no_grad():
        m_x = conv(x.permute(0, 3, 1, 2)).mean(dim=(0, 2, 3))
        m_p = conv(tm._pseudo_images().permute(0, 3, 1, 2)).mean(
            dim=(0, 2, 3))
        tm(x, train=True, draws=Draws(torch.Generator().manual_seed(0),
                                      torch.device("cpu")))
    want = 0.9 * (0.9 * r0 + 0.1 * m_x) + 0.1 * m_p
    close(t2n(bn.running_mean), t2n(want), atol=1e-6, rtol=1e-5)
    assert not torch.equal(dec_bn.running_mean, d0)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_matches_jax(case, monkeypatch):
    """The eval step (``M_N=1.0``, running statistics, the state's step
    passed to the forward and the loss, no buffer written) against JAX's
    ``make_eval_step``, its draws replayed."""
    from ctvae_tpu.training import state as jstate
    jm, variables, tm = _pair(case)
    step = CASES[case][1]
    jstate_ = jstate.TrainState(
        step=jnp.array(step, jnp.int32), params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=(), rng=jax.random.PRNGKey(2))
    x = _images(31)
    with recorded_draws(monkeypatch, seed=9) as rec:
        want = jax.device_get(jax.jit(jstate.make_eval_step(
            jm, M_N=1.0, fwd_kwargs_keys=()))(jstate_,
                                              {"image": jnp.asarray(x)}))
    replay = ReplayDraws(rec.draws)
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    state.step = step
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


def test_categorical_temperature_follows_the_step():
    """CategoricalVAE's temperature: ``temperature * exp(-anneal_rate *
    last)`` at the last multiple of ``anneal_interval``, clamped from
    below at ``temperature`` (constant for a positive rate, as in the
    reference), from a Python int or a tensor."""
    _, _, tm = _pair("CategoricalVAE-step5")
    for step, last in ((0, 0), (1, 0), (5, 4), (torch.tensor(7), 6)):
        assert math.isclose(float(tm._temp(step)), 0.5 * math.exp(0.1 * last),
                            rel_tol=1e-6)
    _, _, tm = _pair("CategoricalVAE-step0")
    assert float(tm._temp(10 ** 6)) == 0.5


# --- the registry and the init -----------------------------------------------

NEW_NAMES = ["IWAE", "MIWAE", "SWAE", "BetaTCVAE", "CategoricalVAE",
             "GumbelVAE", "JointVAE", "GammaVAE", "VampVAE", "HVAE", "LVAE"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_fields_match_the_jax_dataclass(name):
    """Each new name (and the alias ``GumbelVAE``) maps to the JAX
    registry's class counterpart and takes every field of its dataclass;
    ``build_model`` drops the keys JAX drops (``kld_weight``)."""
    from ctvae_tpu.models import vae_models as jax_models
    from ctvae_torch.models import build_model, model_fields, vae_models
    assert vae_models[name].__name__ == jax_models[name].__name__
    want = set(jax_models[name].__dataclass_fields__) - {"parent", "name"}
    assert model_fields(vae_models[name]) == want
    cfg = next(c for c, _, _ in CASES.values()
               if vae_models[c["name"]] is vae_models[name])
    tm = build_model(dict(cfg, name=name, kld_weight=0.1), device="cpu")
    assert type(tm) is vae_models[name] and tm.device.type == "cpu"


def _fan_in(module, p):
    from torch import nn
    if isinstance(module, nn.ConvTranspose2d):
        return p.shape[0] * p.shape[2] * p.shape[3]
    if isinstance(module, nn.Conv2d):
        return p.shape[1] * p.shape[2] * p.shape[3]
    return p.shape[1]


@pytest.mark.parametrize("name", ["IWAE", "MIWAE", "SWAE", "BetaTCVAE",
                                  "CategoricalVAE", "JointVAE", "GammaVAE",
                                  "VampVAE", "HVAE", "LVAE"])
def test_build_model_init_ranges(name):
    """At each model's default widths: every conv and linear kernel has
    flax's ``lecun_normal`` spread (standard deviation 1 / sqrt(fan_in)
    within 10% where it has 256 values or more, nothing past two of
    them), biases are zero, BatchNorm
    (NCHW, and LVAE's over [B, D]) starts at scale 1, bias 0, running mean
    0 and variance 1, and GammaVAE's ``fc_mu`` / ``fc_var`` kernels are
    orthogonal as flax's ``orthogonal()`` draws them (W^T W = I of the
    [in, out] kernel, within 1e-5)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.models.backbones import BatchNorm
    tm = build_model({"name": name}, device="cpu").requires_grad_(False)
    bns = [m for m in tm.modules() if isinstance(m, BatchNorm)]
    assert bool(bns) == (name != "BetaTCVAE")
    for m in bns:
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
        assert torch.equal(m.running_mean, torch.zeros_like(m.bias))
        assert torch.equal(m.running_var, torch.ones_like(m.bias))
    if name == "LVAE":
        assert tm.ladders_0.BatchNorm_0.weight.shape == (32,)
    ortho = {id(getattr(tm, n)) for n in getattr(tm, "orthogonal_kernels",
                                                 ())}
    assert len(ortho) == (2 if name == "GammaVAE" else 0)
    for mname, module in tm.named_modules():
        if isinstance(module, BatchNorm):
            continue
        for pname, p in module.named_parameters(recurse=False):
            n = f"{mname}.{pname}"
            if pname == "bias":
                assert torch.equal(p, torch.zeros_like(p)), n
            elif id(module) in ortho:
                w = p.double()                      # [out, in] = W^T
                close(t2n(w @ w.T), np.eye(p.shape[0]), atol=1e-5, rtol=0)
            else:
                std = 1.0 / math.sqrt(_fan_in(module, p))
                if p.numel() >= 256:    # HVAE's 1x1 embed_data has 9
                    assert abs(float(p.std()) / std - 1.0) < 0.1, n
                assert float(p.abs().max()) <= 2.0 * std * 1.1369 + 1e-7, n


# --- the converter -----------------------------------------------------------

def test_converter_picks_layouts_by_the_port_module_type():
    """A flax ConvTranspose with in == out channels named ``final_up``
    and a BatchNorm named ``final_bn`` (neither name carries its type, as
    in LVAE and BetaTCVAE) convert to the port's ConvTranspose2d and
    BatchNorm: the eval outputs agree with flax's, with random running
    statistics and scale. A kernel laid out by its name would keep its
    (3, 3, 8, 8) shape but lose the tap flip and the axis order."""
    import flax.linen as fnn
    from torch import nn

    from ctvae_torch.models.backbones import BatchNorm

    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.ConvTranspose(8, (3, 3), strides=(2, 2),
                                  padding=((1, 2), (1, 2)),
                                  name="final_up")(x)
            return fnn.BatchNorm(use_running_average=True, momentum=0.9,
                                 epsilon=1e-5, name="final_bn")(x)

    class PortUp(nn.Module):
        def __init__(self):
            super().__init__()
            self.final_up = nn.ConvTranspose2d(8, 8, 3, stride=2, padding=1,
                                               output_padding=1)
            self.final_bn = BatchNorm(8)

        def forward(self, x):
            x = self.final_up(x.permute(0, 3, 1, 2))
            return self.final_bn(x, train=False).permute(0, 2, 3, 1)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    variables = jax.device_get(Up().init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    variables = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables)
    port = PortUp()
    port.load_state_dict(from_jax_params(variables, port))
    want = Up().apply(variables, jnp.asarray(x))
    _close_scaled(t2n(port(torch.from_numpy(x))), want)
    flipped = t2n(port.final_up.weight)
    kernel = variables["params"]["final_up"]["kernel"]
    assert not np.allclose(flipped, kernel.transpose(3, 2, 0, 1))


# --- serving, the metrics' representation, the grids -------------------------

@pytest.mark.parametrize("case,name", [("HVAE", "encode"), ("LVAE", "encode"),
                                       ("IWAE", "reconstruct"),
                                       ("HVAE", "sample"),
                                       ("LVAE", "sample")])
def test_serving_matches_jax(case, name, monkeypatch):
    """The port's serving entry points against
    ``ctvae_tpu.serving.export.make_inference_fn`` on replayed draws:
    HVAE's ``encode`` draws z2 and returns z1's mu, LVAE's unwraps its
    rungs to the lowest one's mu, IWAE's ``reconstruct`` returns the whole
    [B, S, H, W, C] ``recons`` as JAX's does."""
    from ctvae_tpu.serving import export as jexport
    from ctvae_torch.serving import inference
    jm, variables, tm = _pair(case)
    x = _images(41)
    args = () if name == "sample" else (x,)
    jfn = jax.jit(jexport.make_inference_fn(jm, variables, name,
                                            num_samples=3))
    with recorded_draws(monkeypatch, seed=6) as rec:
        want = jax.device_get(jfn(jax.random.PRNGKey(0),
                                  *map(jnp.asarray, args)))
    replay = ReplayDraws(rec.draws)
    monkeypatch.setattr(inference, "_draws", lambda model, gen: replay)
    got = inference.make_inference_fn(tm, name, num_samples=3)(
        *map(torch.from_numpy, args))
    assert replay.done() and got.is_inference()
    assert got.shape == want.shape
    if (case, name) == ("IWAE", "reconstruct"):
        assert want.shape == (B, 3, IMG, IMG, 3)
    _close_scaled(t2n(got), want)


@pytest.mark.parametrize("case", ["HVAE", "LVAE"])
def test_repr_fn_is_the_first_encoder_output(case):
    """``make_repr_fn`` (the metrics' representation) gives the serving
    ``encode`` of the same fixed-seed draws, the same at every call (JAX's
    ``repr_fn`` passes fixed keys), for HVAE's drawing encoder and LVAE's
    nested one."""
    from ctvae_torch.serving.inference import make_inference_fn
    from ctvae_torch.training.experiment import make_repr_fn
    _, _, tm = _pair(case)
    x = _images(42)
    fn = make_repr_fn(tm)
    a, b = fn(x), fn(torch.from_numpy(x))
    want = make_inference_fn(tm, "encode")(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(a, want)
    assert a.shape == (B, 8 if case == "HVAE" else 4)
    if case == "HVAE":   # z2 is drawn: another seed moves z1's mu
        other = make_inference_fn(tm, "encode")(
            torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
        assert not torch.equal(a, other)


@pytest.mark.parametrize("case", ["IWAE", "LVAE"])
def test_run_train_writes_the_three_grids(case, tmp_path):
    """``run.train`` of the small model on the synthetic data for one
    epoch on the CPU: finite losses, a checkpoint, and the Inputs,
    Reconstructions (IWAE's ``generate``: sample 0) and Samples grids."""
    from ctvae_torch import run
    cfg = {"model_params": dict(CASES[case][0]),
           "data_params": dict(dataset_name="Synthetic", train_batch_size=8,
                               val_batch_size=8, patch_size=IMG, n=64),
           "exp_params": dict(EXP, kld_weight=0.00025, manual_seed=1),
           "trainer_params": {"max_epochs": 1},
           "logging_params": {"save_dir": str(tmp_path), "name": case}}
    out = run.train(cfg, device="cpu")
    assert math.isfinite(out["val_loss"]) and math.isfinite(
        out["train_loss"])
    run_dir = tmp_path / case / "version_0"
    assert (run_dir / "checkpoints" / "last").exists()
    for sub in ("Inputs", "Reconstructions", "Samples"):
        assert len(os.listdir(run_dir / sub)) == 1, sub


# --- the configs at full width -----------------------------------------------

YAMLS = ["iwae", "miwae", "swae", "betatc_vae", "cat_vae", "joint_vae",
         "gammavae", "vampvae", "hvae", "lvae"]


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_forward_and_loss_match_jax_at_full_width(name, monkeypatch):
    """``configs/<name>.yaml``'s model as ``read_config`` reads it (img 64,
    the published widths) at B = 2, weights from ``_full_width_variables``:
    the eval forward and the loss at the YAML's ``kld_weight`` against
    JAX, draws replayed, at the tolerances above."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    cfg = read_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    mp, kld = cfg["model_params"], cfg["exp_params"]["kld_weight"]
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    jm = jax_build(dict(mp))
    variables = _full_width_variables(jm, x)
    tm = build_model(dict(mp), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    with recorded_draws(monkeypatch, seed=3) as rec:
        j_out, j_loss = jax.jit(lambda v, x: (lambda o: (
            o, jm.loss_function(o, **_jax_loss_kwargs(1, kld, False))))(
            jm.apply(v, x, train=False, rngs=_rngs(),
                     step=jnp.asarray(1, jnp.int32))))(
            variables, jnp.asarray(x))
    j_out, j_loss = jax.device_get((j_out, j_loss))
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=False, draws=replay,
                 step=torch.tensor(1))
        loss = tm.loss_function(out, M_N=kld, step=torch.tensor(1),
                                train=False, optimizer_idx=0, draws=replay)
    assert replay.done()
    _compare_outputs(out, j_out)
    assert set(loss) == set(j_loss)
    for k, v in j_loss.items():
        close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["iwae", "vampvae", "hvae", "lvae"])
def test_yaml_lr_blows_up_in_jax_as_in_the_port(name, monkeypatch):
    """``configs/iwae.yaml`` (LR 0.007), ``vampvae.yaml``, ``hvae.yaml``
    and ``lvae.yaml`` (LR 0.005) as written at B = 16 on uniform
    images: two train steps in JAX and in
    the port from the same converted weights (``_full_width_variables``),
    batches and draws (JAX's jitted step keeps its recorded draws as
    constants, so both steps take the same ones). The first step's
    metrics agree at the tolerances above; after its Adam update both
    sides' KL grows by more than an order of magnitude (or is no longer
    finite), the two within 25% of each other (the growth amplifies the
    first step's rounding): the first update moves each log-variance
    head's 2,048-32,768 inputs' weights by LR together, and the KL's
    exponentials blow up (here IWAE's by 68x, VampVAE's, HVAE's and
    LVAE's by 2e5 to 6e14x; on the card IWAE's loss went from 0.52 to
    3e5 and, once, to NaN). The run is unstable in the reference
    implementation itself, so a run of these configs on the card may end
    with non-finite losses."""
    import optax

    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    cfg = read_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    mp, exp = cfg["model_params"], cfg["exp_params"]
    assert exp["LR"] >= 0.005
    x = np.random.default_rng(7).uniform(size=(2, 16, 64, 64, 3)).astype(
        np.float32)
    jm = jax_build(dict(mp))
    variables = _full_width_variables(jm, x[0, :2])
    params = variables["params"]
    tx = jopt.build_optimizers(exp, params, 100)[0]
    j_state = jstate.TrainState(
        step=jnp.array(0, jnp.int32), params=params,
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=(tx.init(params),), rng=jax.random.PRNGKey(1))
    j_step = jax.jit(jstate.make_train_step(
        jm, [tx], M_N=exp["kld_weight"], static_fwd_kwargs={"mode": "base"}))
    with recorded_draws(monkeypatch, seed=3) as rec:
        j_state, m0 = j_step(j_state, {"image": jnp.asarray(x[0])})
    j_state, m1 = j_step(j_state, {"image": jnp.asarray(x[1])})
    want = [jax.device_get(m) for m in (m0, m1)]
    tm = build_model(dict(mp), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm,
                                                                100))
    step = tstate.make_train_step("base", M_N=exp["kld_weight"])
    got = []
    for xi in x:
        replay = ReplayDraws(rec.draws)
        monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
        got.append({k: float(v) for k, v in step(
            state, {"image": torch.from_numpy(xi)}).items()})
        assert replay.done()
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        close(got[0][k], v, atol=1e-6, rtol=LOSS_RTOL)
    kld = (got[1]["KLD"], float(want[1]["KLD"]))
    for side in kld:
        assert not math.isfinite(side) or abs(side) > 10 * abs(
            got[0]["KLD"]), kld
    if all(map(math.isfinite, kld)):
        assert abs(kld[0] - kld[1]) <= 0.25 * abs(kld[1]), kld


def test_lvae_prior_samples_overflow_in_jax_as_in_the_port(monkeypatch):
    """``configs/lvae.yaml``'s ``sample`` at random init (weights from
    ``_full_width_variables``): the ladder's variances compound over its
    four rungs (each rung's ``exp(log_var / 2)`` grows with the latent
    it reads), so some of 4,096 prior draws reach non-finite latents and
    decode to non-finite images, in JAX as in the port. On the same
    replayed draws the same rows are non-finite on both sides, the
    finite ones agree within 1e-3 of each row's largest magnitude (the
    exponentials multiply the rounding of each log-variance by up to
    half its size at every rung: 2.9e-4 at most here, the median
    5e-7), and four non-finite latents decode to non-finite images on
    both sides. So a serving check of LVAE's ``sample`` at random init
    may meet non-finite rows that are the reference's own."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.models.base import reparameterize as jax_reparameterize
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    from ctvae_torch.models.base import reparameterize
    mp = read_config(os.path.join(REPO, "configs", "lvae.yaml"))[
        "model_params"]
    jm = jax_build(dict(mp))
    variables = _full_width_variables(jm, np.zeros((2, 64, 64, 3),
                                                   np.float32))
    tm = build_model(dict(mp), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    z0 = np.random.default_rng(8).standard_normal((4096, 128)).astype(
        np.float32)

    def chain(m, z):
        for ladder in m.ladders:
            mu, log_var = ladder(z, train=False)
            z = jax_reparameterize(m.make_rng("reparam"), mu, log_var)
        return z

    with recorded_draws(monkeypatch, seed=9) as rec:
        want = np.asarray(jax.jit(lambda v, z: jm.apply(
            v, z, method=chain, rngs=_rngs()))(variables, jnp.asarray(z0)))
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        z = torch.from_numpy(z0)
        for ladder in tm._ladders():
            z = reparameterize(*ladder(z, train=False), replay)
    assert replay.done()
    got = t2n(z)
    finite = np.isfinite(got).all(1)
    assert np.array_equal(finite, np.isfinite(want).all(1))
    assert 0 < (~finite).sum() < 0.1 * len(finite)
    scale = np.abs(want[finite]).max(1, keepdims=True)
    assert (np.abs(got[finite] - want[finite]) <= 1e-3 * scale).all()
    rows = np.flatnonzero(~finite)[:4]
    with torch.no_grad():
        images = t2n(tm._run_decoder(torch.from_numpy(got[rows]),
                                     train=False))
    j_images = np.asarray(jm.apply(variables, jnp.asarray(want[rows]),
                                   train=False, method=jm._run_decoder))
    for side in (images, j_images):
        assert not np.isfinite(side.reshape(len(rows), -1)).all(1).any()


def test_gamma_vae_gradient_overflows_in_jax_as_in_the_port(monkeypatch):
    """GammaVAE divides by its rate, a softmax (``z / beta``): once a rate
    falls to about 1e-19 the gradient ``-z / beta^2`` passes f32's range
    and the step is non-finite, in JAX as in the port. The small model
    with ``fc_var``'s first bias at -42 (that rate about 1e-19, where
    ``configs/gammavae.yaml`` at ``manual_seed`` 1265 took the port on
    the card within 6 steps): one train step on the same draws gives a
    finite loss within the tolerances above and a non-finite gradient
    norm on both sides."""
    jm, variables, tm = _pair("GammaVAE")
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["params"]["fc_var"]["bias"][0] = -42.0
    tm.load_state_dict(from_jax_params(variables, tm))
    b = {"image": _images(17)}
    _, _, j_metrics, draws, _ = jax_train_step_state(
        jm, variables, "base", {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=5, exp=EXP, M_N=M_N)
    with torch.no_grad():
        beta = tm.encode(torch.from_numpy(b["image"]))[1]
    assert float(beta.min()) < 1e-18
    metrics = _port_step(tm, b, draws, 0)
    close(t2n(metrics["loss"]), j_metrics["loss"], atol=1e-6,
          rtol=LOSS_RTOL)
    assert math.isfinite(float(metrics["loss"]))
    for g in (float(metrics["grad_norm"]), float(j_metrics["grad_norm"])):
        assert not math.isfinite(g), g
