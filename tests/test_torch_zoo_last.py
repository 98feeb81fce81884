"""The last of the model registry in the port against the JAX package at
small widths (img 32, hidden_dims [8, 16], latent 8, B = 4; TwoStageVAE's
stage-2 MLPs [16, 12]): ``ops/ssim.py::mssim_loss`` (both window modes,
``normalize`` on and off, an odd size the pools trim; values and the
gradient), the frozen VGG19-bn (its taps on converted weights, the
in-place-ReLU quirk, ``load_vgg19_bn_weights`` from a torchvision-format
``state_dict``, the refusal without weights), then per model (MSSIMVAE
with each window, DFCVAE, FactorVAE, TwoStageVAE at stages 1 and 2) the
eval forward and loss, a train step (metrics, gradients, parameters,
both optimizers' Adam moments, BatchNorm's buffers) and the eval step;
FactorVAE over two batches x two optimizer calls; the registry; the
loop (``run.train`` with two optimizers, resume, the VGG in no
optimizer); TwoStageVAE's two-stage ``sample``; and the three YAMLs at
full width at B = 2.

Inputs come from numpy with a seed; JAX variables cross through
``from_jax_params`` (DFCVAE's ``frozen`` collection too); every draw
(normals, FactorVAE's per-row permutations) is recorded on the JAX side
and replayed into the port (tests/torch_port_common.py). A jitted JAX
step keeps its recorded draws as constants, so each optimizer's step
takes the same draws at every batch, and so does the port's replay.
Tolerances, those of tests/test_torch_zoo.py: forward values within 1e-5
of the output's largest magnitude; losses and metrics rtol 1e-4 (atol
1e-6); gradients within 1e-5 of max(1, their block's largest) (DFCVAE's
1e-3, FactorVAE's 1e-4: ``GRAD_REL`` says why); each parameter
after n Adam updates within n (2e-6 + LR / 1e-8 times the sum of its
gradient's differences) (``torch_port_common.assert_steps_match``'s
bound); Adam's first moments within the gradients' tolerance and second
moments within 1e-2 of it times max(1, the block's largest gradient)
(a moment is a mean of gradients, of their squares times 1e-3 in the
first steps); buffers atol 1e-5 / rtol 1e-4. A run of several calls
starts each from JAX's parameters and buffers (``_Run.call``). MS-SSIM values within 1e-6 (one minus a product of terms
near 1, rounded in f32: ~1e-7 apart here), its gradient within 1e-4 of
its largest (each element sums 5 scales of 121-tap windows; the
reference's inverted window put the two sides 1.02e-5 apart).
"""

import copy
import json
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctvae_torch.convert import _convert_leaf, from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from test_torch_zoo import LOSS_RTOL, M_N, _block, _close_scaled
from torch_port_common import (ReplayDraws, close, keep_grads,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, IMG, D = 4, 32, 8
GAUSS = dict(in_channels=3, latent_dim=D, hidden_dims=[8, 16], img_size=IMG)
EXP = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
#: FactorVAE's optimizers as configs/factorvae.yaml sets them, with other
#: rates and decays so that each optimizer's own reaches its updates
FVAE_EXP = dict(EXP, LR_2=4e-3, scheduler_gamma_2=0.5,
                submodel="discriminator", retain_first_backpass=True)
TWO = dict(name="TwoStageVAE", hidden_dims2=[16, 12], **GAUSS)

#: case -> (model_params, exp_params, the draws of a train step in order,
#: of the eval forward)
CASES = {
    "MSSIMVAE": (dict(name="MSSIMVAE", **GAUSS), EXP,
                 [("normal", (B, D))], []),
    "MSSIMVAE-reference": (dict(name="MSSIMVAE", window_size=7,
                                window_mode="reference", **GAUSS), EXP,
                           [("normal", (B, D))], []),
    "DFCVAE": (dict(name="DFCVAE", alpha=0.7, beta=0.4,
                    allow_random_features=True, **GAUSS), EXP,
               [("normal", (B, D))], []),
    # the reparameterisation, then the permutation (drawn in eval too)
    "FactorVAE": (dict(name="FactorVAE", gamma=6.4, **GAUSS), FVAE_EXP,
                  [("normal", (B, D)), ("permutation", (B, D))],
                  [("permutation", (B, D))]),
    # z, then the stage-2 u
    "TwoStageVAE-1": (dict(TWO, train_stage=1), EXP,
                      [("normal", (B, D)), ("normal", (B, D))], []),
    "TwoStageVAE-2": (dict(TWO, train_stage=2), EXP,
                      [("normal", (B, D)), ("normal", (B, D))], []),
}

#: gradients' tolerance over max(1, the block's largest) where it is not
#: 1e-5. DFCVAE's loss is not smooth: a max-pool's argmax or a ReLU's
#: side in the VGG moves with the last bits of the reconstruction, and
#: routes a feature gradient elsewhere (at this init the port's f32 run
#: on one thread put the decoder's gradients up to 1.3e-4 from JAX's and
#: 1.4e-2 of the reconstruction gradient's scale from the port's own
#: float64 run; on eight threads 8e-7). FactorVAE's reach the encoder
#: through the discriminator's 1000-wide layers times gamma: each side
#: ~1e-5 of the block's largest from a float64 run, 4.8e-5 apart here
GRAD_REL = {"DFCVAE": 1e-3, "FactorVAE": 1e-4}

_PAIRS = {}


def _images(seed: int, n: int = B, size: int = IMG) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        size=(n, size, size, 3)).astype(np.float32)


def _rngs():
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    return dict(zip(("reparam", "gumbel", "noise", "dropout"), keys))


def _build_jax(cfg):
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.models.twostage_vae import TwoStageVAE
    cfg = dict(cfg)
    if cfg["name"] != "TwoStageVAE":
        return jax_build(cfg)
    cfg.pop("name")
    return TwoStageVAE(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()})


def _build_port(cfg):
    from ctvae_torch.models import TwoStageVAE, build_model, init_weights
    cfg = dict(cfg)
    if cfg["name"] != "TwoStageVAE":
        return build_model(cfg, device="cpu")
    cfg.pop("name")
    model = TwoStageVAE(**cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval()


def _pair(case: str):
    """(JAX model, its variables, the port's model on the CPU with the
    JAX variables converted), built once per case."""
    if case not in _PAIRS:
        cfg = CASES[case][0]
        jm = _build_jax(cfg)
        keys = jax.random.split(jax.random.PRNGKey(0), 5)
        variables = jax.device_get(jax.jit(
            lambda r, x: jm.init(r, x, train=False))(
            dict(zip(("params", "reparam", "gumbel", "noise", "dropout"),
                     keys)), jnp.asarray(_images(0, 2))))
        tm = _build_port(cfg)
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
        if isinstance(v, (list, tuple)):    # DFCVAE's feature taps
            assert len(out[k]) == len(v)
            for got, want in zip(out[k], v):
                _close_scaled(t2n(got), want)
        else:
            _close_scaled(t2n(out[k]), v)


# --- MS-SSIM -----------------------------------------------------------------

#: case -> (window_mode, normalize, size, second image: "near" the first
#: (positive contrast terms) or "inverted" (1 - the first: negative ones))
SSIM_CASES = {
    "gaussian-normalize": ("gaussian", True, 32, "near"),
    "reference-normalize": ("reference", True, 32, "near"),
    "gaussian-raw": ("gaussian", False, 32, "near"),
    "gaussian-raw-inverted": ("gaussian", False, 32, "inverted"),
    "reference-raw-inverted": ("reference", False, 32, "inverted"),
    "gaussian-normalize-inverted": ("gaussian", True, 32, "inverted"),
    "odd-size": ("gaussian", True, 37, "near"),
}


@pytest.mark.parametrize("case", list(SSIM_CASES))
def test_mssim_loss_matches_jax(case):
    """``mssim_loss`` against ``ctvae_tpu.ops.ssim.mssim_loss``: the value
    (NaN exactly where JAX's is: without ``normalize`` an inverted image's
    negative contrast terms give NaN powers) and, where finite, the
    gradient with respect to the first image; 37 x 37 images lose a row
    and a column at the pools (37 -> 18 -> 9 -> 4 -> 2)."""
    from ctvae_tpu.ops.ssim import mssim_loss as jax_mssim
    from ctvae_torch.ops.ssim import mssim_loss
    mode, normalize, size, other = SSIM_CASES[case]
    a = _images(3, 3, size)
    b = (np.clip(a + 0.1 * np.random.default_rng(4).normal(size=a.shape),
                 0, 1) if other == "near" else 1.0 - a).astype(np.float32)
    kw = dict(window_size=11, normalize=normalize, window_mode=mode)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda x, y: jax_mssim(x, y, **kw)))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_(True)
    got = mssim_loss(x, torch.from_numpy(b), **kw)
    nan = not math.isfinite(float(want))
    assert nan == (other == "inverted" and not normalize)
    assert math.isnan(float(got.detach())) == nan
    if nan:
        return
    close(float(got.detach()), float(want), atol=1e-6, rtol=0)
    got.backward()
    _close_scaled(t2n(x.grad), np.asarray(want_g), rel=1e-4)


def test_mssim_product_multiplies_the_last_scale_four_times():
    """The final combination is JAX's ``prod(pow1[:-1] * pow2[-1])``: the
    last scale's SSIM term enters four times (not the reference's once),
    checked on the port's own per-scale terms."""
    from ctvae_torch.ops import ssim
    a = torch.from_numpy(_images(5, 2))
    b = torch.from_numpy(_images(6, 2))
    sims, css = [], []
    window = torch.from_numpy(ssim._window_np(11, 1.5))
    x, y = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    for _ in range(5):
        s, c = ssim._ssim(x, y, window)
        sims.append((float(s) + 1) / 2)
        css.append((float(c) + 1) / 2)
        x, y = (torch.nn.functional.avg_pool2d(t, 2) for t in (x, y))
    w = ssim._MSSSIM_WEIGHTS
    want = 1.0 - math.prod(css[i] ** w[i] * sims[4] ** w[4]
                           for i in range(4))
    close(float(ssim.mssim_loss(a, b)), want, atol=1e-6, rtol=0)


# --- the frozen VGG19-bn -------------------------------------------------------

def _jax_vgg(layers, seed: int = 0):
    """A JAX ``FrozenVGG19BN`` tapping ``layers`` with He-normal kernels and
    random biases and BatchNorm statistics (so the comparison has teeth),
    its variables, and the port's module with them converted."""
    from ctvae_tpu.models.vgg import FrozenVGG19BN as JaxVGG
    from ctvae_torch.models.vgg import FrozenVGG19BN
    jv = JaxVGG(feature_layers=tuple(layers))
    frozen = jax.device_get(jv.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, IMG, IMG, 3)))["frozen"])
    rng = np.random.default_rng(seed)
    for k, v in frozen.items():
        if k.endswith("_mean") or k.endswith("bias"):
            frozen[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k.endswith(("_var", "_scale")):
            frozen[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    tv = FrozenVGG19BN(feature_layers=layers, device="cpu")
    tv.load_state_dict(from_jax_params({"params": {}, "frozen": frozen}, tv))
    return jv, frozen, tv


@pytest.mark.parametrize("layers", [("14", "24", "34", "43"),
                                    ("24", "3", "25", "13")])
def test_vgg_taps_match_jax(layers):
    """The port's taps against JAX's ``FrozenVGG19BN`` on the converted
    ``frozen`` collection (HWIO kernels -> OIHW buffers), in the order
    asked: a tap at a BatchNorm index followed by a ReLU ('24') yields the
    post-ReLU activation, the same as the ReLU's own tap ('25'); conv
    taps ('3', '14', '43') and the pool's ('13') yield their outputs. The
    port holds buffers up to the largest tap and no parameter."""
    jv, frozen, tv = _jax_vgg(layers)
    x = _images(7, 2)
    want = jax.device_get(jax.jit(lambda f, x: jv.apply({"frozen": f}, x))(
        frozen, jnp.asarray(x)))
    with torch.no_grad():
        got = tv(torch.from_numpy(x))
    assert len(got) == len(want) == len(layers)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_scaled(t2n(g), w)
    assert not list(tv.parameters())
    assert {int(n.split("_")[0].lstrip("conbv")) for n, _ in
            tv.named_buffers()} <= set(range(tv.last + 1))
    taps = dict(zip(layers, got))
    if "25" in taps:
        assert torch.equal(taps["24"], taps["25"])
        assert bool((taps["24"] >= 0).all())
        assert bool((taps["3"] < 0).any())     # a conv's output
    else:
        assert bool((taps["14"] < 0).any()) and bool(
            (taps["24"] >= 0).all())


def _torchvision_state_dict(seed: int = 1):
    """A ``state_dict`` in torchvision's vgg19_bn layout (``features.<i>.
    weight`` OIHW, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``; the classifier's keys too), random values."""
    from ctvae_torch.models.vgg import _sequential_plan
    g = torch.Generator().manual_seed(seed)
    sd, fin = {}, 3
    for idx, (kind, ch) in enumerate(_sequential_plan()):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.randn(ch, fin, 3, 3,
                                                       generator=g) * 0.05
            sd[f"features.{idx}.bias"] = torch.randn(ch, generator=g) * 0.1
            fin = ch
        elif kind == "bn":
            sd[f"features.{idx}.weight"] = 1 + 0.2 * torch.randn(
                ch, generator=g)
            sd[f"features.{idx}.bias"] = 0.2 * torch.randn(ch, generator=g)
            sd[f"features.{idx}.running_mean"] = 0.3 * torch.randn(
                ch, generator=g)
            sd[f"features.{idx}.running_var"] = 0.5 + torch.rand(
                ch, generator=g)
            sd[f"features.{idx}.num_batches_tracked"] = torch.tensor(7)
    sd["classifier.0.weight"] = torch.randn(16, 8, generator=g)
    return sd


def test_load_vgg19_bn_weights_from_a_torchvision_state_dict(tmp_path,
                                                             monkeypatch):
    """``CTVAE_VGG19_WEIGHTS`` names a torchvision-format file:
    ``VAEXperiment.setup`` of a DFCVAE loads every buffer of its VGG from
    it (``attach_pretrained_vgg``), equal to the file's tensors and to
    JAX's ``load_vgg19_bn_weights`` of the same file, converted; the taps
    then agree with JAX's on those weights."""
    from ctvae_tpu.models.vgg import FrozenVGG19BN as JaxVGG
    from ctvae_tpu.models.vgg import load_vgg19_bn_weights as jax_load
    from ctvae_torch.training import VAEXperiment
    sd = _torchvision_state_dict()
    path = str(tmp_path / "vgg19_bn.pth")
    torch.save(sd, path)
    monkeypatch.setenv("CTVAE_VGG19_WEIGHTS", path)
    _, _, tm = _pair("DFCVAE")
    VAEXperiment(tm, EXP, None).setup()
    vgg = tm.feature_network
    for name, buf in vgg.named_buffers():
        layer, suffix = name.split("_", 1)
        idx = layer.lstrip("conbv")
        key = {"weight": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}[suffix]
        assert torch.equal(buf, sd[f"features.{idx}.{key}"]), name
    jv = JaxVGG()
    fresh = jax.device_get(jv.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, IMG, IMG, 3)))["frozen"])
    frozen = jax.device_get(jax_load(dict(fresh), path))
    want = from_jax_params({"params": {}, "frozen": frozen}, vgg)
    for name, buf in vgg.named_buffers():
        assert torch.equal(buf, want[name]), name
    x = _images(8, 2)
    j_taps = jax.device_get(jv.apply({"frozen": frozen}, jnp.asarray(x)))
    with torch.no_grad():
        for g, w in zip(vgg(torch.from_numpy(x)), j_taps):
            _close_scaled(t2n(g), w)


def test_dfc_vae_refuses_random_features_as_jax_does(tmp_path, monkeypatch):
    """With no weights anywhere (``CTVAE_VGG19_WEIGHTS`` naming no file, a
    ``HOME`` without the caches): ``configs/dfc_vae.yaml``'s model as
    written refuses ``VAEXperiment.setup`` with the RuntimeError that names
    ``allow_random_features``, in the port as in JAX; with the key set, both
    warn and proceed with random features."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_tpu.training.experiment import VAEXperiment as JaxExperiment
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    from ctvae_torch.models.vgg import attach_pretrained_vgg
    from ctvae_torch.training import VAEXperiment
    monkeypatch.setenv("CTVAE_VGG19_WEIGHTS", str(tmp_path / "none.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = read_config(os.path.join(REPO, "configs", "dfc_vae.yaml"))
    mp = dict(cfg["model_params"], hidden_dims=[8, 16], img_size=IMG)
    exp = cfg["exp_params"]
    batch = {"image": np.zeros((2, IMG, IMG, 3), np.float32)}
    for allow in (False, True):
        mp["allow_random_features"] = allow
        tm = build_model(mp, device="cpu")
        jexp = JaxExperiment(jax_build(dict(mp)), exp, None)
        texp = VAEXperiment(tm, exp, None)
        if not allow:
            for setup in (lambda: jexp.setup(batch), texp.setup):
                with pytest.raises(RuntimeError,
                                   match="allow_random_features"):
                    setup()
            continue
        for setup in (lambda: jexp.setup(batch), texp.setup):
            with pytest.warns(UserWarning, match="RANDOM features"):
                setup()
    # a model without a VGG passes untouched, weights or not
    other = build_model(dict(GAUSS, name="VanillaVAE"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert attach_pretrained_vgg(other) is other


def test_vgg_is_in_no_optimizer_and_no_norm():
    """DFCVAE's VGG: its weights are buffers (in the ``state_dict``, so in
    checkpoints), in no optimizer, in no ``grad_norm`` or ``grad_norm/
    <module>`` / ``param_norm/<module>``, and bit-unchanged by train steps
    while gradients flow through it to the decoder."""
    _, _, tm = _pair("DFCVAE")
    vgg = dict(tm.feature_network.named_buffers())
    assert len(vgg) == 14 * 2 + 13 * 4     # up to conv 43
    assert all(f"feature_network.{n}" in tm.state_dict() for n in vgg)
    before = {n: b.clone() for n, b in vgg.items()}
    opts = topt.build_optimizers(EXP, tm, 4)
    held = {id(p) for o in opts for p in o.params}
    assert held == {id(p) for p in tm.parameters()}
    state = tstate.create_train_state(tm, opts)
    step = tstate.make_train_step("base", watch_modules=True)
    for seed in (1, 2):
        metrics = step(state, {"image": torch.from_numpy(_images(seed))})
    assert not any("feature_network" in k for k in metrics)
    assert {k for k in metrics if k.startswith("grad_norm/")} == {
        "grad_norm/encoder", "grad_norm/head", "grad_norm/decoder_input",
        "grad_norm/decoder"}
    for n, b in tm.feature_network.named_buffers():
        assert torch.equal(b, before[n]), n
    assert float(tm.decoder.Conv_0.weight.grad.abs().sum()) > 0


# --- per model: forward and loss, train step, eval step ------------------------

def _jax_loss_kwargs(optimizer_idx):
    return dict(M_N=M_N, step=jnp.asarray(0, jnp.int32), train=False,
                optimizer_idx=optimizer_idx, rng=jax.random.PRNGKey(7))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_jax(case, monkeypatch):
    """The eval forward (running statistics; FactorVAE's permutation) and
    ``loss_function`` at ``M_N`` = 0.5 (FactorVAE at ``optimizer_idx`` 0
    and 1), every output (DFCVAE's feature taps) and every loss term; the
    draws' kinds and order asserted."""
    jm, variables, tm = _pair(case)
    idxs = (0, 1) if case == "FactorVAE" else (0,)
    x = _images(21)
    with recorded_draws(monkeypatch, seed=4) as rec:
        j_out, j_losses = jax.jit(lambda v, x: (lambda o: (o, [
            jm.loss_function(o, **_jax_loss_kwargs(i)) for i in idxs]))(
            jm.apply(v, x, train=False, rngs=_rngs(),
                     step=jnp.asarray(0, jnp.int32))))(variables,
                                                       jnp.asarray(x))
    j_out, j_losses = jax.device_get((j_out, j_losses))
    assert _kinds(rec.draws) == CASES[case][3]
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=False, draws=replay,
                 step=torch.tensor(0))
        losses = [tm.loss_function(out, M_N=M_N, step=torch.tensor(0),
                                   train=False, optimizer_idx=i,
                                   draws=replay) for i in idxs]
    assert replay.done()
    _compare_outputs(out, j_out)
    for loss, j_loss in zip(losses, j_losses):
        assert set(loss) == set(j_loss)
        for k, v in j_loss.items():
            close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state (through
    ``masked``)."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, optax.MaskedState):
        return _adam_state(opt_state.inner_state)
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _port_tree(tree, tm):
    """A JAX param-shaped tree (masked leaves left out) by the port's
    parameter names, in the port's layouts."""
    modules = dict(tm.named_modules())
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, arr = _convert_leaf(tuple(str(k.key) for k in path),
                                  np.asarray(leaf), modules)
        out[name] = torch.from_numpy(np.array(arr))
    return out


class _Run:
    """JAX's ``make_train_step`` and the port's, call after call, on the
    same batches and replayed draws, from the same converted variables;
    ``call(batch, i)`` runs the step of optimizer ``i`` on both sides and
    holds every metric, gradient, parameter, buffer and both optimizers'
    Adam moments to JAX's (the tolerances of the module doc), then loads
    JAX's parameters and buffers into the port for the next call."""

    def __init__(self, case, monkeypatch, steps_per_epoch=4):
        from ctvae_tpu.training import optimizers as jopt
        from ctvae_tpu.training import state as jstate
        self.jm, variables, self.tm = _pair(case)
        self.case, self.monkeypatch = case, monkeypatch
        self.exp = CASES[case][1]
        params = variables["params"]
        self.txs = [optax.chain(keep_grads(), tx) for tx in
                    jopt.build_optimizers(self.exp, params, steps_per_epoch)]
        self.jstate = jstate.TrainState(
            step=jnp.array(0, jnp.int32), params=params,
            model_state={k: v for k, v in variables.items()
                         if k != "params"},
            opt_states=tuple(tx.init(params) for tx in self.txs),
            rng=jax.random.PRNGKey(12))
        self.state = tstate.create_train_state(
            self.tm, topt.build_optimizers(self.exp, self.tm,
                                           steps_per_epoch))
        self.lrs = [self.exp["LR"], self.exp.get("LR_2", 0.0)]
        self.j_steps, self.draws = {}, {}
        self.updates = {n: 0 for n, _ in self.tm.named_parameters()}
        self.diff = {n: torch.zeros_like(p)
                     for n, p in self.tm.named_parameters()}
        self.scale = {}
        self.names = {id(p): n for n, p in self.tm.named_parameters()}

    def _jax_step(self, b, i):
        from ctvae_tpu.training import state as jstate
        if i not in self.j_steps:
            self.j_steps[i] = jax.jit(jstate.make_train_step(
                self.jm, self.txs, M_N=M_N, optimizer_idx=i,
                fwd_kwargs_keys=(), static_fwd_kwargs={"mode": "base"}))
            with recorded_draws(self.monkeypatch, seed=30 + i) as rec:
                out = self.j_steps[i](self.jstate, b)
            self.draws[i] = rec.draws
            return out
        return self.j_steps[i](self.jstate, b)

    def call(self, x, i):
        self.jstate, j_metrics = self._jax_step({"image": jnp.asarray(x)}, i)
        j = jax.device_get(self.jstate)
        j_metrics = jax.device_get(j_metrics)
        assert _kinds(self.draws[i]) == CASES[self.case][2]
        replay = ReplayDraws(self.draws[i])
        start = {n: t.clone() for n, t in self.tm.state_dict().items()}
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tstate, "Draws", lambda gen, device: replay)
            metrics = tstate.make_train_step("base", M_N=M_N,
                                             optimizer_idx=i)(
                self.state, {"image": torch.from_numpy(x)})
        assert replay.done()
        #: what the port's call changed (parameters and buffers)
        self.moved = {n for n, t in self.tm.state_dict().items()
                      if not torch.equal(t, start[n])}
        assert self.state.step == int(j.step)
        assert set(metrics) == set(j_metrics)
        for k, v in j_metrics.items():
            close(t2n(metrics[k]), v, atol=1e-6, rtol=LOSS_RTOL)
        tm = self.tm
        want_g = from_jax_params(j.opt_states[i][0], tm)
        for name, g in want_g.items():
            b = _block(name)
            self.scale[b] = max(self.scale.get(b, 1.0),
                                float(g.abs().max()))
        opt = self.state.optimizers[i]
        updated = {self.names[id(p)] for p in opt.params}
        rel = GRAD_REL.get(self.case, 1e-5)
        for name, p in tm.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            close(t2n(g), want_g[name].numpy(),
                  atol=rel * self.scale[_block(name)], rtol=0)
            if name in updated:
                self.updates[name] += 1
                self.diff[name] += (g - want_g[name]).abs()
        want_p = from_jax_params(j.params, tm)
        lr = max(self.lrs)
        for name, p in tm.named_parameters():
            tol = self.updates[name] * (2e-6 + lr / 1e-8 * self.diff[name])
            assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), \
                name
        want_b = from_jax_params({"params": j.params, **j.model_state}, tm)
        for n, t in tm.named_buffers():
            close(t2n(t), want_b[n].numpy(), atol=1e-5, rtol=1e-4)
        for k, o in enumerate(self.state.optimizers):
            adam = _adam_state(j.opt_states[k][1])
            mu, nu = _port_tree(adam.mu, tm), _port_tree(adam.nu, tm)
            held = {self.names[id(p)]: st for p, st in o.adam.state.items()}
            assert set(held) <= set(mu), sorted(set(held) - set(mu))
            for name, want in mu.items():
                st = held.get(name)
                s = self.scale.get(_block(name), 1.0)
                for key, w, atol in (("exp_avg", want, rel * s),
                                     ("exp_avg_sq", nu[name],
                                      1e-2 * rel * s * s)):
                    got = (st[key] if st is not None
                           else torch.zeros_like(w))
                    close(t2n(got), w.numpy(), atol=atol, rtol=0)
        # the next call starts from JAX's parameters and buffers: Adam
        # steps by g / (|g| + 1e-8), so an element whose gradient is near
        # rounding noise moves by up to LR on one side and not the other,
        # and later calls would compare different points (after one
        # FactorVAE update some LeakyReLU inputs changed side and the
        # second batch's gradient norms were 1% apart); each side's
        # optimizer state, step and schedule carry on
        with torch.no_grad():
            tm.load_state_dict(want_b)
        return metrics, j


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """One train step of optimizer 0 at ``M_N`` = 0.5 against JAX's: the
    draws' kinds and order, every metric and ``grad_norm``, every gradient
    and parameter, Adam's moments (TwoStageVAE's stage-2 MLPs at stage 1,
    and its stage-1 net at stage 2, get zero gradients: no state in the
    port, zero moments in JAX) and BatchNorm's buffers (the stage-2 MLPs'
    at flax's momentum 0.99; FactorVAE's discriminator's after its three
    passes)."""
    run = _Run(case, monkeypatch)
    run.call(_images(11), 0)
    trained = {n for n, p in run.tm.named_parameters() if p.grad is not None}
    if case.startswith("TwoStageVAE"):      # the other stage's: no gradient
        stage2 = ("encoder2.", "decoder2.", "fc_mu2.", "fc_var2.", "fc_out2.")
        assert all(n.startswith(stage2) == case.endswith("2")
                   for n in trained), sorted(trained)
    assert run.moved == trained | {n for n, _ in run.tm.named_buffers()
                                   if not n.startswith("feature_network.")}


def test_factor_vae_two_batches_two_optimizers(monkeypatch):
    """``configs/factorvae.yaml``'s protocol over two batches: per batch
    the step of optimizer 0 (Adam(LR) over every parameter, the
    discriminator too, on the VAE loss with ``gamma`` times the TC term)
    then of optimizer 1 (Adam(LR_2), weight decay 0, over the
    discriminator alone, on the discriminator's loss), each against JAX's
    after each call: metrics, gradients, parameters, both Adam states
    (optimizer 1's untouched by call 0, optimizer 0's by call 1), and
    BatchNorm's buffers (the encoder's and decoder's take one pass per
    call, the discriminator's three: D_z, D_z_sg, D_z_perm). With one step
    per epoch the second batch runs at LR x 0.95 and LR_2 x 0.5
    (``scheduler_gamma_2``). Call 1 leaves every parameter outside the
    discriminator bit-unchanged; ``TrainState.step`` ends at 4. Each call
    starts from JAX's parameters and buffers (``_Run.call`` says why)."""
    run = _Run("FactorVAE", monkeypatch, steps_per_epoch=1)
    tm = run.tm
    for batch in (1, 2):
        x = _images(40 + batch)
        m0, _ = run.call(x, 0)
        assert {"VAE_TC_Loss", "KLD"} <= set(m0)
        assert run.moved == set(tm.state_dict())
        m1, j = run.call(x, 1)
        assert set(m1) == {"loss", "D_TC_Loss", "grad_norm"}
        params = {n for n, _ in tm.named_parameters()}
        assert run.moved & params == {
            n for n in params if n.startswith("discriminator.")}
        assert {n for n, _ in tm.named_buffers()} <= run.moved
    assert run.state.step == 4 == int(j.step)
    opt0, opt1 = run.state.optimizers
    assert (opt0.count, opt1.count) == (2, 2)
    assert {run.names[id(p)].split(".")[0] for p in opt1.params} == {
        "discriminator"}
    assert len(opt0.params) == len(list(tm.parameters()))
    scheds = topt.build_lr_schedules(FVAE_EXP, 1)
    assert [s(1) for s in scheds] == pytest.approx([5e-3 * 0.95, 4e-3 * 0.5])


def test_factor_vae_discriminator_statistics_take_three_passes():
    """The discriminator's first BatchNorm after one train forward: the
    momentum-0.9 fold of the batch statistics of z, of z detached (the
    same values) and of the permuted z, in that order (flax's)."""
    from ctvae_torch.models.base import Draws
    _, _, tm = _pair("FactorVAE")
    bn, dense = tm.discriminator.BatchNorm_0, tm.discriminator.Dense_0
    r0 = bn.running_mean.clone()
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(_images(13))
    with torch.no_grad():
        out = tm(x, train=True, draws=Draws(gen, torch.device("cpu")))
        perms = Draws(torch.Generator().manual_seed(3),
                      torch.device("cpu"))
        perms.normal((B, D))
        z = out["z"]
        z_perm = torch.gather(z, 1, perms.permutation(B, D))
        m_z, m_p = dense(z).mean(0), dense(z_perm).mean(0)
    want = 0.9 * (0.9 * (0.9 * r0 + 0.1 * m_z) + 0.1 * m_z) + 0.1 * m_p
    close(t2n(bn.running_mean), t2n(want), atol=1e-6, rtol=1e-5)


def test_permutation_draws_differ_per_row(monkeypatch):
    """``Draws.permutation(B, D)`` gives a permutation of range(D) in every
    row, rows differing, reproducibly from a seed; the test recorder hands
    JAX's ``permute_latent`` one per row as well (two rows differ), and
    ``permute_latent`` gathers each row by its own."""
    from ctvae_tpu.models import fvae as jfvae
    from ctvae_torch.models.base import Draws
    from ctvae_torch.models.fvae import permute_latent
    draws = Draws(torch.Generator().manual_seed(0), torch.device("cpu"))
    p = draws.permutation(16, 128)
    assert p.dtype == torch.int64 and p.shape == (16, 128)
    assert torch.equal(p.sort(1).values, torch.arange(128).expand(16, 128))
    assert len({tuple(r.tolist()) for r in p}) == 16
    again = Draws(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert torch.equal(again.permutation(16, 128), p)
    z = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    with recorded_draws(monkeypatch, seed=1) as rec:
        zp = np.asarray(jax.jit(lambda z: jfvae.permute_latent(
            jax.random.PRNGKey(0), z))(jnp.asarray(z)))
    (kind, perms), = rec.draws
    assert kind == "permutation" and len({tuple(r) for r in perms}) == 4
    got = permute_latent(ReplayDraws(rec.draws), torch.from_numpy(z))
    np.testing.assert_array_equal(t2n(got), zp)
    np.testing.assert_array_equal(np.sort(zp, 1), np.sort(z, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_matches_jax(case, monkeypatch):
    """The eval step (``M_N=1.0``, optimizer 0's loss, running statistics,
    no buffer written) against JAX's ``make_eval_step``, its draws
    replayed (FactorVAE's permutation)."""
    from ctvae_tpu.training import state as jstate
    jm, variables, tm = _pair(case)
    js = jstate.TrainState(
        step=jnp.array(0, jnp.int32), params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=(), rng=jax.random.PRNGKey(2))
    x = _images(31)
    with recorded_draws(monkeypatch, seed=9) as rec:
        want = jax.device_get(jax.jit(jstate.make_eval_step(
            jm, M_N=1.0, fwd_kwargs_keys=()))(js, {"image": jnp.asarray(x)}))
    replay = ReplayDraws(rec.draws)
    state = tstate.create_train_state(
        tm, topt.build_optimizers(CASES[case][1], tm, 4))
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


# --- the registry --------------------------------------------------------------

@pytest.mark.parametrize("name", ["MSSIMVAE", "DFCVAE", "FactorVAE",
                                  "TwoStageVAE"])
def test_registry_fields_match_the_jax_dataclass(name):
    """Each name maps to its JAX class's counterpart and takes every field
    of its dataclass; ``build_model`` drops the keys JAX drops
    (``kld_weight``). TwoStageVAE is in neither registry, and importable
    from both packages' ``models``; the port's registry now holds every
    name and alias of JAX's."""
    from ctvae_tpu import models as jmodels
    from ctvae_torch import models as tmodels
    jcls, tcls = getattr(jmodels, name), getattr(tmodels, name)
    assert tcls.__name__ == jcls.__name__
    want = set(jcls.__dataclass_fields__) - {"parent", "name"}
    assert tmodels.model_fields(tcls) == want
    assert set(tmodels.vae_models) == set(jmodels.vae_models)
    for k, cls in jmodels.vae_models.items():
        assert tmodels.vae_models[k].__name__ == cls.__name__, k
    if name == "TwoStageVAE":
        assert name not in tmodels.vae_models and \
            name not in jmodels.vae_models
        return
    tm = tmodels.build_model(dict(GAUSS, name=name, kld_weight=0.1),
                             device="cpu")
    assert type(tm) is tcls and tm.device.type == "cpu"


def test_build_model_init_ranges():
    """DFCVAE's VGG as flax fills its ``frozen`` collection: conv kernels
    He-normal (standard deviation sqrt(2 / fan_in) within 10%, nothing past
    two of them), conv biases and BatchNorm means and biases 0, scales and
    variances 1; TwoStageVAE's stage-2 BatchNorm at momentum 0.99, the
    zoo's at 0.9."""
    from ctvae_torch.models import build_model
    tm = build_model({"name": "DFCVAE"}, device="cpu")
    for n, b in tm.feature_network.named_buffers():
        if n.endswith("_weight"):
            std = math.sqrt(2.0 / (b.shape[1] * 9))
            assert abs(float(b.std()) / std - 1.0) < 0.1, n
            assert float(b.abs().max()) <= 2.0 * std * 1.1369 + 1e-7, n
        else:
            fill = 1.0 if n.endswith(("_scale", "_var")) else 0.0
            assert torch.equal(b, torch.full_like(b, fill)), n
    _, _, two = _pair("TwoStageVAE-1")
    assert two.encoder2.BatchNorm_0.momentum == 0.99
    assert two.encoder.ConvBNBlock_0.BatchNorm_0.momentum == 0.9


def test_multi_train_step_takes_one_optimizer():
    """A multi-step train step refuses a state with two optimizers (the
    loop runs them per batch, step by step)."""
    _, _, tm = _pair("FactorVAE")
    state = tstate.create_train_state(tm, topt.build_optimizers(
        FVAE_EXP, tm, 4))
    x = torch.from_numpy(_images(3))[None]
    with pytest.raises(ValueError, match="one optimizer"):
        tstate.make_multi_train_step("base", 1)(state, {"image": x})


# --- the loop, serving ---------------------------------------------------------

def test_run_train_factor_vae_with_two_optimizers(tmp_path):
    """``run.train`` of the small FactorVAE with ``configs/factorvae.yaml``'s
    exp_params (``retain_first_backpass`` accepted) on the synthetic data,
    one epoch, then a full-state resume to two: per batch both optimizers step
    (``TrainState.step`` = 2 x the batches); ``scalars.jsonl`` has ``lr``
    and ``lr_2`` at the schedules' values; the checkpoint holds two Adam
    states, which the resumed run loads and continues from; the
    validation metrics are the VAE phase's."""
    from ctvae_torch import run
    from ctvae_torch.config import read_config
    from ctvae_torch.utils.checkpoint import _load
    exp = read_config(os.path.join(REPO, "configs", "factorvae.yaml"))[
        "exp_params"]
    assert exp["submodel"] == "discriminator" and exp["retain_first_backpass"]
    cfg = {"model_params": dict(CASES["FactorVAE"][0], img_size=16),
           "data_params": dict(dataset_name="Synthetic", train_batch_size=8,
                               val_batch_size=8, patch_size=16, n=600),
           "exp_params": dict(exp, scheduler_gamma_2=0.5),
           "trainer_params": {"max_epochs": 1},
           "logging_params": {"save_dir": str(tmp_path), "name": "fvae"}}
    out = run.train(cfg, device="cpu")
    assert math.isfinite(out["val_loss"]) and "val_VAE_TC_Loss" in out
    spe = int(out["train_steps_base"])
    assert spe > 50         # the logger writes at step 50
    assert out["train_lr_2"] == pytest.approx(0.005)
    run_dir = tmp_path / "fvae" / "version_0"
    blob = _load(str(run_dir / "checkpoints" / "last"))
    assert blob["step"] == 2 * spe
    assert len(blob["optimizers"]) == 2
    assert [o["count"] for o in blob["optimizers"]] == [spe, spe]
    # the discriminator's four Linear and three BatchNorm layers
    assert len(blob["optimizers"][1]["adam"]["state"]) == 14
    with open(run_dir / "scalars.jsonl") as f:
        lines = [json.loads(line) for line in f]
    lr = {ln["step"]: ln["lr"] for ln in lines if "lr" in ln}
    lr_2 = {ln["step"]: ln["lr_2"] for ln in lines if "lr_2" in ln}
    assert lr_2 and lr_2.keys() == lr.keys()
    assert all(v == pytest.approx(0.005) for v in (*lr.values(),
                                                  *lr_2.values()))
    cfg["trainer_params"] = {"max_epochs": 2, "resume_from_checkpoint":
                             str(run_dir / "checkpoints" / "last")}
    out = run.train(cfg, device="cpu")
    assert out["train_lr_2"] == pytest.approx(0.005 * 0.5)
    blob = _load(str(tmp_path / "fvae" / "version_1" / "checkpoints" /
                     "last"))
    assert blob["step"] == 2 * 2 * spe
    assert [o["count"] for o in blob["optimizers"]] == [2 * spe, 2 * spe]


def test_run_train_dfc_vae_with_random_features(tmp_path, monkeypatch):
    """``run.train`` of the small DFCVAE with ``allow_random_features`` and
    no weights: one epoch with finite losses, the three grids, and a
    checkpoint that carries the VGG's buffers as the model ended with
    them (its starting ones)."""
    from ctvae_torch import run
    from ctvae_torch.utils.checkpoint import _load
    monkeypatch.setenv("CTVAE_VGG19_WEIGHTS", str(tmp_path / "none.pth"))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = {"model_params": dict(CASES["DFCVAE"][0]),
           "data_params": dict(dataset_name="Synthetic", train_batch_size=8,
                               val_batch_size=8, patch_size=IMG, n=64),
           "exp_params": dict(EXP, kld_weight=0.00025, manual_seed=1),
           "trainer_params": {"max_epochs": 1},
           "logging_params": {"save_dir": str(tmp_path), "name": "dfc"}}
    with pytest.warns(UserWarning, match="RANDOM features"):
        out = run.train(cfg, device="cpu")
    assert math.isfinite(out["val_loss"]) and math.isfinite(out["train_loss"])
    run_dir = tmp_path / "dfc" / "version_0"
    for sub in ("Inputs", "Reconstructions", "Samples"):
        assert len(os.listdir(run_dir / sub)) == 1, sub
    model = _load(str(run_dir / "checkpoints" / "last"))["model"]
    from ctvae_torch.models import build_model
    fresh = build_model(cfg["model_params"], device="cpu",
                        generator=torch.Generator().manual_seed(1))
    vgg = {k: v for k, v in model.items() if k.startswith("feature_network")}
    assert len(vgg) == 80
    for k, v in vgg.items():
        assert torch.equal(v, fresh.state_dict()[k]), k


@pytest.mark.parametrize("two_stage", [True, False])
def test_two_stage_sample_matches_jax(two_stage, monkeypatch):
    """TwoStageVAE's ``sample`` (u ~ N(0, I) -> ``decode2`` -> the decoder,
    or u decoded directly) against JAX's on the same normals, with running
    statistics made non-trivial by a train forward on both sides; serving's
    ``sample`` entry point is the two-stage one."""
    from ctvae_torch.serving.inference import make_inference_fn
    jm, variables, tm = _pair("TwoStageVAE-2")
    x = _images(5)
    with recorded_draws(monkeypatch, seed=2) as rec:
        _, mutated = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, rngs=_rngs(), mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    variables = {**variables, **jax.device_get(mutated)}
    with torch.no_grad():
        tm(torch.from_numpy(x), train=True, draws=ReplayDraws(rec.draws))
    want_b = from_jax_params(variables, tm)
    for n, t in tm.named_buffers():
        close(t2n(t), want_b[n].numpy(), atol=1e-5, rtol=1e-4)
    with recorded_draws(monkeypatch, seed=3) as rec:
        want = jax.device_get(jax.jit(lambda v: jm.apply(
            v, 5, rngs=_rngs(), two_stage=two_stage, method=jm.sample))(
            variables))
    assert _kinds(rec.draws) == [("normal", (5, D))]
    with torch.no_grad():
        got = tm.sample(5, draws=ReplayDraws(rec.draws), two_stage=two_stage)
    _close_scaled(t2n(got), want)
    if two_stage:
        from ctvae_torch.serving import inference
        monkeypatch.setattr(inference, "_draws",
                            lambda model, gen: ReplayDraws(rec.draws))
        served = make_inference_fn(tm, "sample", num_samples=5)()
        assert torch.equal(served, got)


# --- the configs at full width -------------------------------------------------

def _full_width_variables(jm, x, seed: int = 0):
    """Variables of the tree ``jm.init`` would make (``eval_shape``: no
    init runs), filled from numpy: kernels (the VGG's ``conv<i>_kernel``
    too) normal with variance 1 / fan-in, scales and variances one, the
    rest zero."""
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            dict(zip(("params", "reparam", "gumbel", "noise",
                                      "dropout"),
                                     jax.random.split(jax.random.PRNGKey(0),
                                                      5))),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf.endswith("kernel"):
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, fan ** -0.5, s.shape).astype(np.float32)
        return np.full(s.shape, 1.0 if leaf.endswith(("scale", "var"))
                       else 0.0, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", ["mssim_vae", "dfc_vae", "factorvae"])
def test_yaml_forward_and_loss_match_jax_at_full_width(name, monkeypatch):
    """``configs/<name>.yaml``'s model as ``read_config`` reads it (img 64,
    the published widths; DFCVAE's whole VGG to layer 43) at B = 2: the
    eval forward and the loss (FactorVAE's at both optimizer indices) at
    the YAML's ``kld_weight`` against JAX, draws replayed."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    cfg = read_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    mp, kld = cfg["model_params"], cfg["exp_params"]["kld_weight"]
    idxs = (0, 1) if mp["name"] == "FactorVAE" else (0,)
    x = _images(5, 2, 64)
    jm = jax_build(dict(mp))
    variables = _full_width_variables(jm, x)
    tm = build_model(dict(mp), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    kw = [dict(_jax_loss_kwargs(i), M_N=kld) for i in idxs]
    with recorded_draws(monkeypatch, seed=3) as rec:
        j_out, j_losses = jax.jit(lambda v, x: (lambda o: (o, [
            jm.loss_function(o, **k) for k in kw]))(
            jm.apply(v, x, train=False, rngs=_rngs(),
                     step=jnp.asarray(0, jnp.int32))))(
            variables, jnp.asarray(x))
    j_out, j_losses = jax.device_get((j_out, j_losses))
    replay = ReplayDraws(rec.draws)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=False, draws=replay,
                 step=torch.tensor(0))
        losses = [tm.loss_function(out, M_N=kld, step=torch.tensor(0),
                                   train=False, optimizer_idx=i,
                                   draws=replay) for i in idxs]
    assert replay.done()
    _compare_outputs(out, j_out)
    for loss, j_loss in zip(losses, j_losses):
        assert set(loss) == set(j_loss)
        for k, v in j_loss.items():
            close(t2n(loss[k]), v, atol=1e-6, rtol=LOSS_RTOL)
