"""The port at ``dtype: bfloat16`` against the JAX package at bfloat16,
and the two block keys (``pairwise_block_rows``, ``gat_block_cols``).

* Rows 2-5 of the kernel table (the pairwise scores and the GATv2
  attention, forward and gradients): the port's plain versions at
  bfloat16 against the JAX Pallas kernels in interpret mode, on the same
  bfloat16 inputs. Both load bfloat16, compute in float32 and round once,
  so they agree within 2 bfloat16 ulps (``ULP`` = 2^-8, relative) of
  each element plus 1e-5 of the output's scale (float32 sums in another
  order).
* Row 6 (the per-head logits) against ``fused_gat_logits`` and its
  one-walk VJP, which JAX runs as XLA math in bfloat16 (every add,
  product and sum rounded to bfloat16), while the port computes in
  float32 as the kernels do: within 2 ulps of the output's scale for the
  logits and 32 for the gradients (sums of up to 11 bfloat16 terms), and
  the port itself within 2 ulps of each element (plus 1e-5 of the scale)
  of the same function in float64.
* ``convert.py`` keeps each leaf's dtype (bfloat16 for the CT layer's
  own parameters) and refuses a leaf of another dtype.
* CTMCQVAE's four serving entry points and one train step per mode,
  MCQVAE's, VQVAE's and VanillaVAE's forward, loss and train step, against
  JAX at bfloat16 with the draws replayed (tests/torch_port_common.py). Values
  that bfloat16 rounds differently by an ulp can flip a decision: a VQ
  index, the argmax of the CT layer's output, a Gumbel-Bernoulli sample.
  Each such decision is tapped on both sides (``Taps``): the port's may
  differ from JAX's only where JAX's own margin is within the rounding
  the two sides' inputs differ by, and the port then continues on JAX's
  decision. Values within 4 ulps of their scale (the decoders' images,
  the probabilities), the losses within 5 ulps (2 %: they sum bfloat16
  products over the batch). Gradients cancel in places (and JAX on the
  CPU sums a bfloat16 convolution's bias and weight gradients in a
  bfloat16 accumulator that stalls), so two bfloat16 steps are not a few
  ulps apart: each gradient leaf and ``grad_norm`` of the port must be
  within twice JAX's distance of the port's float32 step on the same
  values, draws and decisions, plus 2 ulps; each parameter after Adam
  within 2 ulps of JAX's where the two gradients' signs agree (Adam's
  first step is LR times the sign), and a sign may differ only where
  the float32 gradient is within JAX's own rounding of zero
  (``assert_bf16_step_matches``).
* The CT model's multi-step graph (``scan_steps``) against eager steps
  at bfloat16 on the CPU, bit for bit.
* The block keys at float32: the chunked plain path against the
  unchunked one and against JAX's block path within 1e-6.
* ``dtype: bfloat16`` from YAML, six other registry members built at
  bfloat16 (tests/test_torch_bf16_zoo*.py hold the rest of the registry
  against JAX), the refusals of other dtypes naming ROADMAP A6, and
  ``torch.library.opcheck`` of every custom op at bfloat16.

JAX runs the Pallas kernels (``CTVAE_FLASH_GAT=1``,
``CTVAE_FLASH_PAIRWISE=1``, as tests/test_torch_ops.py does), in
interpret mode on the CPU.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from torch_bf16_common import (BF, EXP, ULP, Taps, _f, _tb,  # noqa: F401
                               _train_step_pair, assert_bf16_rounding,
                               assert_bf16_step_matches, assert_ulps)
from torch_port_common import (MCQ, SMALL, ReplayDraws, batch, close,
                               jax_rngs, one_torch_thread, recorded_draws,
                               t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODES = ("base", "action", "causal")


@pytest.fixture(autouse=True)
def _flash(monkeypatch):
    monkeypatch.setenv("CTVAE_FLASH_GAT", "1")
    monkeypatch.setenv("CTVAE_FLASH_PAIRWISE", "1")


def _jax_vjp(f, args, ct):
    """``f(*args)`` and its VJP at ``ct``, in one jitted call (eager JAX
    would compile each operation of the interpret-mode kernels alone)."""
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)
    return jax.jit(run)(tuple(args), ct)


# --- rows 2-6: the plain versions at bfloat16 --------------------------------

def _pairwise_inputs(rng, B, S, T, H, per_sample):
    pshape = (B, H) if per_sample else (H,)
    return [rng.normal(size=(B, S, H)) * 0.5, rng.normal(size=(B, T, H)) * 0.5,
            rng.normal(size=pshape) * H ** -0.5, rng.normal(size=pshape) * 0.1,
            rng.normal(size=pshape[:-1]) * 0.1]


@pytest.mark.parametrize("per_sample", [False, True])
def test_pairwise_matches_pallas_at_bf16(per_sample):
    """Rows 2-3: ``flash_pairwise`` at bfloat16 against JAX's kernel in
    interpret mode: the bfloat16 scores and the five gradients (dxl, dxr
    in bfloat16; dw2, db1, db2 summed in float32 and cast once)."""
    from ctvae_tpu.ops.pairwise_flash import flash_pairwise as jfp
    from ctvae_torch.ops.pairwise_flash import flash_pairwise
    rng = np.random.default_rng(1 + per_sample)
    B, S, T, H = 2, 9, 11, 24
    arrays = _pairwise_inputs(rng, B, S, T, H, per_sample)
    dout = rng.normal(size=(B, S, T))
    want, want_g = _jax_vjp(lambda *a: jfp(*a, 0.01, True),
                            [jnp.asarray(a, BF) for a in arrays],
                            jnp.asarray(dout, BF))
    leaves = [_tb(a).requires_grad_() for a in arrays]
    got = flash_pairwise(*leaves, 0.01)
    got_g = torch.autograd.grad(got, leaves, _tb(dout))
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, what="scores")
    for name, g, w in zip(("dxl", "dxr", "dw2", "db1", "db2"), got_g, want_g):
        assert g.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_ulps(g, w, what=name)


def _gat_inputs(rng, B, S, T, H, F):
    mask = rng.uniform(size=(B, S, T)) < 0.6
    mask[:, :, 2] = False              # a target without an incoming edge
    return ([rng.normal(size=(B, S, H, F)), rng.normal(size=(B, T, H, F)),
             rng.uniform(size=(B, S, T)) * mask,
             rng.normal(size=(H, F)) * 0.3, rng.normal(size=(H, F)) * 0.3],
            mask)


def test_gat_matches_pallas_at_bf16():
    """Rows 4-5: ``flash_gat`` at bfloat16 against JAX's kernel in
    interpret mode: the bfloat16 output, the float32 alpha residual, and
    the gradients of xl, xr, adj, we and att in bfloat16."""
    from ctvae_tpu.ops.gat_flash import _flash_fwd_raw
    from ctvae_tpu.ops.gat_flash import flash_gat as jfg
    from ctvae_torch.ops import library
    from ctvae_torch.ops.gat_flash import flash_gat
    rng = np.random.default_rng(3)
    B, S, T, H, F = 2, 9, 9, 3, 8
    arrays, mask = _gat_inputs(rng, B, S, T, H, F)
    dout = rng.normal(size=(B, T, H, F))
    jm = jnp.asarray(mask)
    J = [jnp.asarray(a, BF) for a in arrays]
    want, want_g = _jax_vjp(
        lambda xl, xr, adj, we, att: jfg(xl, xr, adj, jm, we, att, 0.2, True),
        J, jnp.asarray(dout, BF))
    _, want_alpha = _flash_fwd_raw(J[0], J[1], J[2], jm, J[3], J[4], 0.2, True)
    leaves = [_tb(a).requires_grad_() for a in arrays]
    tmask = torch.from_numpy(mask)
    got = flash_gat(leaves[0], leaves[1], leaves[2], tmask, leaves[3],
                    leaves[4], 0.2)
    got_g = torch.autograd.grad(got, leaves, _tb(dout))
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, what="out")
    _, alpha = library.gat_fwd_alpha(*(t.detach() for t in leaves[:3]),
                                     tmask, leaves[3].detach(),
                                     leaves[4].detach(), 0.2)
    assert alpha.dtype == torch.float32
    # JAX's residual [B, Tp, Sp, H] (padded) against the port's [B, H, T, S]
    close(t2n(alpha), np.asarray(want_alpha)[:, :T, :S].transpose(0, 3, 1, 2),
          atol=1e-6, rtol=1e-5)
    for name, g, w in zip(("dxl", "dxr", "dadj", "dwe", "datt"), got_g,
                          want_g):
        assert g.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_ulps(g, w, what=name)


@pytest.mark.parametrize("per_sample", [False, True])
def test_gat_logits_matches_jax_at_bf16(per_sample):
    """Row 6: ``fused_gat_logits`` at bfloat16 against JAX's (XLA math in
    bfloat16) and its VJP, and against float64 math on the same
    inputs (see the module doc for the tolerances)."""
    from ctvae_tpu.ops.gat import fused_gat_logits as jfl
    from ctvae_torch.ops.gat import gat_logits
    from ctvae_torch.ops.gat_logits import fused_gat_logits
    rng = np.random.default_rng(5 + per_sample)
    B, S, T, K, F = 2, 9, 11, 2, 40
    pshape = (B, K, F) if per_sample else (K, F)
    arrays = [rng.normal(size=(B, S, K, F)), rng.normal(size=(B, T, K, F)),
              rng.uniform(size=(B, S, T)), rng.normal(size=pshape) * 0.3,
              rng.normal(size=pshape) * 0.3]
    d_e = rng.normal(size=(B, S, T, K))
    want, want_g = _jax_vjp(lambda *a: jfl(*a, 0.2),
                            [jnp.asarray(a, BF) for a in arrays],
                            jnp.asarray(d_e, BF))
    leaves = [_tb(a).requires_grad_() for a in arrays]
    got = fused_gat_logits(*leaves, 0.2)
    got_g = torch.autograd.grad(got, leaves, _tb(d_e))
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, ulps=0, scale_ulps=2, what="logits")
    # float64 math on the same (bfloat16) values
    ref = [t.detach().double().requires_grad_() for t in leaves]
    ref_out = gat_logits(*ref, 0.2)
    ref_g = torch.autograd.grad(ref_out, ref, _tb(d_e).double())
    assert_ulps(got, ref_out, what="logits vs float64")
    for name, g, w, r in zip(("dxl", "dxr", "dadj", "dwe", "datt"), got_g,
                             want_g, ref_g):
        assert g.dtype == torch.bfloat16 and w.dtype == BF, name
        assert_ulps(g, w, ulps=0, scale_ulps=32, what=name)
        assert_ulps(g, r, what=f"{name} vs float64")


def test_kernel_ops_refuse_mixed_dtypes_on_the_card_path():
    """The CPU plain versions take what JAX's kernels take (each input
    upcast); on CUDA tensors every input must be of the main input's
    dtype: a wrapper raises on anything else, without casting."""
    from ctvae_torch.ops.common import kernel_dtype
    assert kernel_dtype("x", torch.zeros(1, dtype=torch.bfloat16)) \
        == torch.bfloat16
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="no kernel"):
            kernel_dtype("x", torch.zeros(1, dtype=dt))


# --- opcheck at bfloat16 -----------------------------------------------------

def _op_cases_bf16(rng):
    from ctvae_torch.ops import library
    B, S, T, H = 3, 9, 13, 33
    pw = (_tb(rng.normal(size=(B, S, H))), _tb(rng.normal(size=(B, T, H))),
          _tb(rng.normal(size=(B, H))), _tb(rng.normal(size=(H,))),
          _tb(rng.normal(size=(B,))))
    out = library.pairwise_fwd(*pw, 0.01)
    arrays, mask = _gat_inputs(rng, 2, 9, 11, 3, 5)
    gat = [_tb(a) for a in arrays]
    gat.insert(3, torch.from_numpy(mask))
    _, alpha = library.gat_fwd_alpha(*gat, 0.2)
    K, F = 2, 40
    lg = (_tb(rng.normal(size=(B, S, K, F))),
          _tb(rng.normal(size=(B, T, K, F))),
          _tb(rng.uniform(size=(B, S, T))),
          _tb(rng.normal(size=(B, K, F)) * 0.3),
          _tb(rng.normal(size=(B, K, F)) * 0.3))
    return {"pairwise_fwd": (*pw, 0.01),
            "pairwise_bwd": (*pw, out, _tb(rng.normal(size=(B, S, T))), 0.01),
            "gat_fwd": (*gat, 0.2), "gat_fwd_alpha": (*gat, 0.2),
            "gat_bwd": (*gat, alpha, _tb(rng.normal(size=(2, 11, 3, 5))),
                        0.2),
            "gat_logits_fwd": (*lg, 0.2),
            "gat_logits_bwd": (*lg, _tb(rng.normal(size=(B, S, T, K))), 0.2)}


@pytest.mark.parametrize("name", [
    "pairwise_fwd", "pairwise_bwd", "gat_fwd", "gat_fwd_alpha", "gat_bwd",
    "gat_logits_fwd", "gat_logits_bwd"])
def test_custom_ops_opcheck_at_bf16(name):
    """``torch.library.opcheck`` of each op at bfloat16 (schema, fake
    kernel's shapes and dtypes against the CPU kernel's, autograd
    registration), and the outputs' dtypes: the inputs' but GAT's float32
    alpha."""
    from ctvae_torch.ops.common import custom_ops
    args = _op_cases_bf16(np.random.default_rng(11))[name]
    op = getattr(custom_ops(), name)
    torch.library.opcheck(op, args)
    out = op(*args)
    outs = (out,) if torch.is_tensor(out) else out
    want = {"gat_fwd_alpha": [torch.bfloat16, torch.float32]}.get(
        name, [torch.bfloat16] * len(outs))
    assert [o.dtype for o in outs] == want


# --- convert.py --------------------------------------------------------------

def _bf16(cfg):
    return dict(cfg, dtype="bfloat16")


VAE_SMALL = dict(name="VanillaVAE", in_channels=3, latent_dim=8,
                 hidden_dims=[8, 16], img_size=16)
VQ_SMALL = dict(name="VQVAE", in_channels=3, embedding_dim=8,
                num_embeddings=16, hidden_dims=[8, 16], img_size=16)


def _jax_init(cfg, seed=0):
    from ctvae_tpu.models import build_model as jax_build
    jm = jax_build(dict(cfg))
    x, y, a = batch(seed, B=2, cfg=dict(SMALL, img_size=cfg["img_size"]))
    if cfg["name"] == "CTMCQVAE":
        init = functools.partial(jm.init, mode="action")
        variables = jax.jit(init)(jax_rngs(seed), jnp.asarray(x),
                                  input_y=jnp.asarray(y),
                                  action=jnp.asarray(a))
    else:
        variables = jax.jit(jm.init)(jax_rngs(seed), jnp.asarray(x))
    return jm, variables


def _pair(cfg, seed=0):
    from ctvae_torch.models import build_model
    jm, variables = _jax_init(cfg, seed)
    tm = build_model(dict(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(variables), tm))
    return jm, variables, tm


@pytest.fixture(scope="module")
def ct_pair():
    return _pair(_bf16(SMALL))


@pytest.mark.parametrize("cfg", [SMALL, MCQ, VQ_SMALL, VAE_SMALL],
                         ids=["CTMCQVAE", "MCQVAE", "VQVAE", "VanillaVAE"])
def test_convert_keeps_leaf_dtypes(cfg):
    """Every parameter and buffer of the port built at bfloat16 has its
    JAX leaf's dtype (bfloat16: the CT layer's own parameters and the
    GAT's lin_edge / att / bias; float32: the Dense / Conv kernels, the
    codebooks, BatchNorm's scale and statistics), and a JAX leaf whose
    dtype is not the port's parameter's is refused."""
    from ctvae_torch.models import build_model
    jm, variables = _jax_init(_bf16(cfg))
    variables = jax.device_get(variables)
    tm = build_model(_bf16(cfg), device="cpu")
    state = from_jax_params(variables, tm)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        flat["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    n_bf16 = sum(str(v.dtype) == "bfloat16" for v in flat.values())
    assert n_bf16 == sum(t.dtype == torch.bfloat16 for t in state.values())
    if cfg["name"] == "CTMCQVAE":
        assert n_bf16 == 13
        assert tm.ct_layer.disc_w1l.dtype == torch.bfloat16
        assert tm.ct_layer.graph_transitioner.DenseGATv2Layer_0.att.dtype \
            == torch.bfloat16
        assert tm.ct_layer.a_dense.weight.dtype == torch.float32
    else:
        assert n_bf16 == 0
    for name, t in tm.state_dict().items():
        assert state[name].dtype == t.dtype, name
    tm.load_state_dict(state)
    if n_bf16:
        with pytest.raises(ValueError, match="bfloat16"):
            from_jax_params(variables, build_model(dict(cfg), device="cpu"))


# --- CTMCQVAE ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["reconstruct", "encode", "apply_action",
                                  "classify_action"])
def test_ct_entry_points_match_jax_at_bf16(monkeypatch, ct_pair, name):
    """The four CT entry points of ``serving/inference.py`` at bfloat16
    against JAX's ``make_inference_fn``: same draws, the flips of the
    tapped decisions checked and replayed (images and probabilities within
    4 ulps of their scale; ``encode``'s bfloat16 latents within 2 ulps of
    each element plus 4 of the scale)."""
    from ctvae_tpu.serving import export as jexport
    from ctvae_torch.serving import inference
    jm, variables, tm = ct_pair
    x, y, a = batch(7, cfg=SMALL)
    args = {"reconstruct": (x,), "encode": (x,),
            "apply_action": (x, y, a), "classify_action": (x, y)}[name]
    taps = Taps()
    with monkeypatch.context() as m:
        taps.jax(m)
        jfn = jax.jit(jexport.make_inference_fn(jm, variables, name))
        with recorded_draws(m, seed=8) as rec:
            want = jax.block_until_ready(
                jfn(jax.random.PRNGKey(0), *map(jnp.asarray, args)))
    draws = ReplayDraws(rec.draws)
    taps.port(monkeypatch)
    monkeypatch.setattr(inference, "_draws", lambda model, gen: draws)
    got = inference.make_inference_fn(tm, name)(*map(torch.from_numpy, args))
    assert draws.done() and taps.done()
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert_ulps(got, want, ulps=2 if name == "encode" else 0, scale_ulps=4,
                what=name)


@pytest.mark.parametrize("mode", MODES)
def test_ct_train_step_matches_jax_at_bf16(monkeypatch, ct_pair, mode):
    """One CT train step per mode at bfloat16 against JAX's: the losses
    within 2 %, ``grad_norm`` and every gradient leaf as accurate as JAX's
    against the port's float32 step, and every parameter after Adam
    (``assert_bf16_step_matches``)."""
    (j_params, j_grads, j_metrics, _), (tm, metrics), (tm32, m32) = \
        _train_step_pair(monkeypatch, ct_pair, mode, SMALL)
    for k in ("loss", "Reconstruction_Loss", "VQ_Loss", "CT_Loss"):
        assert_ulps(metrics[k], j_metrics[k], ulps=5, scale_ulps=0,
                    rel_scale=1e-6, what=k)
    assert_bf16_rounding(metrics["grad_norm"], j_metrics["grad_norm"],
                         m32["grad_norm"], "grad_norm")
    assert_bf16_step_matches(tm, tm32, j_params, j_grads, EXP["LR"])
    # the CT layer's own gradients (the headline config trains it alone)
    # have no long bfloat16 sums in JAX
    want = from_jax_params(j_grads, tm)
    for name, p in tm.ct_layer.named_parameters():
        g = p.grad.double() if p.grad is not None else None
        w = want["ct_layer." + name].double()
        if g is not None and float(w.norm()) > 0:
            cos = float((g * w).sum() / (g.norm() * w.norm()))
            assert cos >= 0.98, (name, cos)


def test_ct_adam_state_dtypes(ct_pair):
    """Adam's moments take their parameter's dtype, as optax's do."""
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    tm = copy.deepcopy(ct_pair[2])
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    x, y, a = batch(3, cfg=SMALL)
    tstate.make_train_step("action")(state, {
        "image": torch.from_numpy(x), "input_y": torch.from_numpy(y),
        "action": torch.from_numpy(a)})
    adam = state.optimizers[0].adam
    stepped = [p for p in tm.parameters() if adam.state.get(p)]
    assert any(p.dtype == torch.bfloat16 for p in stepped)
    for p in stepped:
        st = adam.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == p.dtype
    assert tm.ct_layer.disc_w2.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", MODES)
def test_ct_multi_step_equals_steps_at_bf16(ct_pair, mode):
    """``make_multi_train_step(mode, 2)`` at bfloat16 against two eager
    steps on the same batches: parameters, Adam's moments and the step
    bit for bit."""
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    states = []
    for _ in range(2):
        tm = copy.deepcopy(ct_pair[2])
        states.append(tstate.create_train_state(
            tm, topt.build_optimizers(EXP, tm, 4), seed=5))
    bs = [batch(20 + i, cfg=SMALL) for i in range(2)]
    batches = [{"image": torch.from_numpy(x), "input_y": torch.from_numpy(y),
                "action": torch.from_numpy(a)} for x, y, a in bs]
    step = tstate.make_train_step(mode)
    for b in batches:
        step(states[0], b)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    tstate.make_multi_train_step(mode, 2)(states[1], stacked)
    assert states[0].step == states[1].step == 2
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    for o, r in zip(states[0].optimizers, states[1].optimizers):
        for p, q in zip(o.params, r.params):
            assert o.adam.state.get(p, {}).keys() == \
                r.adam.state.get(q, {}).keys()
            for key in o.adam.state.get(p, {}):
                assert torch.equal(o.adam.state[p][key],
                                   r.adam.state[q][key])


# --- MCQVAE, VQVAE and VanillaVAE --------------------------------------------

@pytest.fixture(scope="module")
def mcq_pair():
    return _pair(_bf16(MCQ))


@pytest.fixture(scope="module")
def vq_pair():
    return _pair(_bf16(VQ_SMALL))


@pytest.fixture(scope="module")
def vae_pair():
    return _pair(_bf16(VAE_SMALL))


def _forward_pair(monkeypatch, pair, train, taps=True):
    jm, variables, tm = pair
    tm = copy.deepcopy(tm)   # a train pass folds BatchNorm's statistics
    x, _, _ = batch(13, cfg=SMALL)
    tp = Taps(lone=type(tm).__name__ == "VQVAE")
    with monkeypatch.context() as m:
        if taps:
            tp.jax(m)
        with recorded_draws(m, seed=14) as rec:
            def fwd(v, x):
                out = jm.apply(v, x, train=train, rngs=jax_rngs(1),
                               mutable=["batch_stats"] if train else False)
                out = out[0] if train else out
                return out, jm.loss_function(out, M_N=0.5)
            want, want_loss = jax.jit(fwd)(variables, jnp.asarray(x))
    draws = ReplayDraws(rec.draws)
    if taps:
        tp.port(monkeypatch)
    got = tm(torch.from_numpy(x), draws=draws, train=train)
    got_loss = tm.loss_function(got, M_N=0.5)
    assert draws.done() and tp.done()
    return want, want_loss, got, got_loss


@pytest.mark.parametrize("train", [False, True])
def test_mcq_vae_forward_and_loss_match_jax_at_bf16(monkeypatch, mcq_pair,
                                                     train):
    """MCQVAE at bfloat16: the float32 reconstruction within 4 ulps of its
    scale, the losses within 2 % (VQ indices tapped)."""
    want, want_loss, got, got_loss = _forward_pair(monkeypatch, mcq_pair,
                                                   train)
    assert got["recons"].dtype == torch.float32
    assert_ulps(got["recons"], want["recons"], ulps=0, scale_ulps=4,
                what="recons")
    for k in ("loss", "Reconstruction_Loss", "VQ_Loss"):
        assert_ulps(got_loss[k], want_loss[k], ulps=5, what=k)


@pytest.mark.parametrize("train", [False, True])
def test_vq_vae_forward_and_loss_match_jax_at_bf16(monkeypatch, vq_pair,
                                                    train):
    """VQVAE at bfloat16 (its lone ``VectorQuantizerMS``, the search in
    float32 on the upcast latents): the float32 reconstruction within 4
    ulps of its scale, the losses within 2 % (VQ indices tapped)."""
    want, want_loss, got, got_loss = _forward_pair(monkeypatch, vq_pair,
                                                   train)
    assert got["recons"].dtype == torch.float32
    assert_ulps(got["recons"], want["recons"], ulps=0, scale_ulps=4,
                what="recons")
    for k in ("loss", "Reconstruction_Loss", "VQ_Loss"):
        assert_ulps(got_loss[k], want_loss[k], ulps=5, what=k)


@pytest.mark.parametrize("train", [False, True])
def test_vanilla_vae_forward_and_loss_match_jax_at_bf16(monkeypatch,
                                                         vae_pair, train):
    """VanillaVAE at bfloat16: mu / log_var in float32 within 4 ulps of
    their scale (BatchNorm in float32 on bfloat16 convolutions), the
    reconstruction within 4 ulps, the losses within 2 %."""
    want, want_loss, got, got_loss = _forward_pair(monkeypatch, vae_pair,
                                                   train, taps=False)
    for k in ("mu", "log_var", "recons"):
        assert got[k].dtype == torch.float32, k
        assert_ulps(got[k], want[k], ulps=0, scale_ulps=4, what=k)
    for k in ("loss", "Reconstruction_Loss", "KLD"):
        assert_ulps(got_loss[k], want_loss[k], ulps=5, what=k)


@pytest.mark.parametrize("which", ["MCQVAE", "VQVAE", "VanillaVAE"])
def test_zoo_train_step_matches_jax_at_bf16(monkeypatch, mcq_pair, vq_pair,
                                            vae_pair, which):
    """One train step of MCQVAE, VQVAE and VanillaVAE at bfloat16 against
    JAX's: the loss within 2 %, ``grad_norm``, every gradient leaf and
    every parameter after Adam (``assert_bf16_step_matches``), and
    BatchNorm's float32 running statistics within 4 ulps of their
    scale."""
    pair, cfg = {"MCQVAE": (mcq_pair, MCQ), "VQVAE": (vq_pair, VQ_SMALL),
                 "VanillaVAE": (vae_pair, VAE_SMALL)}[which]
    (j_params, j_grads, j_metrics, j_state), (tm, metrics), (tm32, m32) = \
        _train_step_pair(monkeypatch, pair, "base", cfg)
    assert_ulps(metrics["loss"], j_metrics["loss"], ulps=5, what="loss")
    assert_bf16_rounding(metrics["grad_norm"], j_metrics["grad_norm"],
                         m32["grad_norm"], "grad_norm")
    assert_bf16_step_matches(tm, tm32, j_params, j_grads, EXP["LR"])
    if which == "VanillaVAE":
        want = from_jax_params({"params": j_params, **j_state}, tm)
        for name, buf in tm.named_buffers():
            assert buf.dtype == torch.float32
            assert_ulps(buf, want[name], ulps=0, scale_ulps=4, what=name)


# --- the block keys ----------------------------------------------------------

def test_pairwise_block_rows_chunked_equals_unchunked_and_jax():
    """``pairwise_mlp_scores(block_rows=...)`` on the CPU goes through the
    plain version a block of rows at a time: equal to the unchunked scores
    and to JAX's block path (``lax.map`` over row blocks, XLA) within
    1e-6, with its gradients, at float32."""
    from ctvae_tpu.ops.pairwise import pairwise_mlp_scores as jpms
    from ctvae_torch.ops.pairwise import pairwise_mlp_scores
    rng = np.random.default_rng(17)
    B, S, H = 2, 11, 24
    arrays = [rng.normal(size=(B, S, H)), rng.normal(size=(B, S, H)),
              rng.normal(size=(B, H)) * H ** -0.5, rng.normal(size=(B,)) * 0.1,
              rng.normal(size=(B, H)) * 0.1]
    dout = rng.normal(size=(B, S, S))
    f32 = [np.asarray(a, np.float32) for a in arrays]
    grads = {}
    for rows in (None, 4, 11, 3):
        leaves = [torch.from_numpy(a).requires_grad_() for a in f32]
        out = pairwise_mlp_scores(*leaves, block_rows=rows)
        grads[rows] = (out, torch.autograd.grad(out, leaves,
                                                torch.from_numpy(dout)))
    with pytest.MonkeyPatch.context() as m:
        m.setenv("CTVAE_FLASH_PAIRWISE", "0")
        want, want_g = _jax_vjp(lambda *a: jpms(*a, block_rows=4),
                                list(map(jnp.asarray, f32)),
                                jnp.asarray(dout, jnp.float32))
    for rows in (4, 11, 3):
        close(t2n(grads[rows][0]), t2n(grads[None][0]), atol=1e-6, rtol=0)
        for g, h in zip(grads[rows][1], grads[None][1]):
            close(t2n(g), t2n(h), atol=1e-6, rtol=0)
    close(t2n(grads[4][0]), want, atol=1e-6, rtol=0)
    for g, w in zip(grads[4][1], want_g):
        close(t2n(g), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("heads", [False, True])
def test_gat_block_cols_chunked_equals_unchunked_and_jax(heads):
    """A GATv2 layer with ``gat_block_cols`` on the CPU: the attention a
    block of targets at a time, and ``heads_call`` through the chunked
    full-head forward (as JAX routes it): equal to the unchunked layer and
    to JAX's ``DenseGATv2Layer(block_cols=...)`` within 1e-6, with the
    gradients of x and adj, at float32."""
    from ctvae_tpu.ops.gat import DenseGATv2Layer as JLayer
    from ctvae_torch.ops.gat import DenseGATv2Layer
    rng = np.random.default_rng(19 + heads)
    B, T, Fin, H, F = 2, 11, 6, 3, 5
    x = rng.normal(size=(B, T, Fin)).astype(np.float32)
    adj = (rng.uniform(size=(B, T, T)) *
           (rng.uniform(size=(B, T, T)) < 0.6)).astype(np.float32)
    idx = np.stack([np.zeros(B, np.int32), rng.integers(1, H, B)], 1)
    jl = JLayer(out_features=F, heads=H, block_cols=4)
    jx, jadj = jnp.asarray(x), jnp.asarray(adj)
    params = jax.jit(jl.init)(jax.random.PRNGKey(0), jx, jadj)

    def jfwd(x, adj):
        if heads:
            return jl.apply(params, x, adj, jnp.asarray(idx),
                            method=JLayer.heads_call)
        return jl.apply(params, x, adj)
    out_shape = jax.eval_shape(jfwd, jx, jadj).shape
    dout = rng.normal(size=out_shape).astype(np.float32)
    want, want_g = _jax_vjp(jfwd, [jx, jadj], jnp.asarray(dout))
    got = {}
    for cols in (0, 4, 11):
        layer = DenseGATv2Layer(Fin, F, heads=H, block_cols=cols)
        layer.load_state_dict(from_jax_params(jax.device_get(params)["params"],
                                              layer))
        leaves = [torch.from_numpy(x).requires_grad_(),
                  torch.from_numpy(adj).requires_grad_()]
        out = (layer.heads_call(*leaves, torch.from_numpy(idx).long())
               if heads else layer(*leaves))
        got[cols] = (out, torch.autograd.grad(out, leaves,
                                              torch.from_numpy(dout)))
    for cols in (0, 4, 11):
        close(t2n(got[cols][0]), want, atol=1e-6, rtol=0)
        for g, w in zip(got[cols][1], want_g):
            close(t2n(g), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["action"])
def test_ct_model_with_block_keys_matches_jax(monkeypatch, mode):
    """The small CT model with ``pairwise_block_rows: 5`` and
    ``gat_block_cols: 4`` (JAX on its XLA block path, the port chunked on
    the CPU): one action step (both discoverers, the mask, ``heads_call``
    through the chunked forward) at float32 against JAX's, within the
    float32 tolerances of tests/test_torch_training.py."""
    from torch_port_common import assert_step_matches
    cfg = dict(SMALL, pairwise_block_rows=5, gat_block_cols=4)
    monkeypatch.setenv("CTVAE_FLASH_GAT", "0")
    monkeypatch.setenv("CTVAE_FLASH_PAIRWISE", "0")
    pair = _pair(cfg)
    (j_params, j_grads, j_metrics, _), (tm, metrics) = _train_step_pair(
        monkeypatch, pair, mode, cfg, twin=False)
    for k in ("loss", "CT_Loss"):
        close(t2n(metrics[k]), j_metrics[k])
    assert_step_matches(tm, j_params, j_grads, EXP["LR"])


# --- YAML and the refusals ---------------------------------------------------

def test_yaml_dtype_bfloat16_builds_the_three_models(tmp_path):
    """``dtype: bfloat16`` in a YAML's model_params, read as the loop
    reads it, builds each model of the slice at bfloat16 (the CT layer's
    parameters in bfloat16, the backbones' in float32 computing in
    bfloat16), and one train step runs with finite losses."""
    from ctvae_torch.config import read_config
    from ctvae_torch.models import build_model
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    for cfg in (SMALL, MCQ, VAE_SMALL):
        text = "model_params:\n" + "".join(
            f"  {k}: {v if not isinstance(v, str) else repr(v)}\n"
            for k, v in dict(cfg, dtype="bfloat16").items())
        path = tmp_path / f"{cfg['name']}.yaml"
        path.write_text(text)
        params = read_config(str(path))["model_params"]
        assert params["dtype"] == "bfloat16"
        tm = build_model(params, device="cpu")
        assert tm.compute_dtype == torch.bfloat16
        x, y, a = batch(2, cfg=SMALL)
        state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm))
        metrics = tstate.make_train_step("action")(state, {
            "image": torch.from_numpy(x), "input_y": torch.from_numpy(y),
            "action": torch.from_numpy(a)})
        assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("name", ["BetaVAE", "MSSIMVAE", "IWAE", "DFCVAE",
                                  "ConditionalVAE", "LVAE"])
def test_other_models_refuse_bf16(name):
    """No longer refused: each of these registry members builds at
    ``dtype: bfloat16`` with ``compute_dtype`` bfloat16, float32
    parameters and float32 buffers (BatchNorm's statistics, DFCVAE's
    frozen VGG), as flax's ``dtype`` keeps them; tests/test_torch_bf16_
    zoo*.py hold each against JAX at bfloat16."""
    from ctvae_torch.models import build_model
    cfg = {"name": name, "dtype": "bfloat16", "img_size": 32,
           "hidden_dims": [8, 16]}
    if name == "LVAE":
        cfg["latent_dims"] = [4, 8]
    tm = build_model(cfg, device="cpu")
    assert tm.compute_dtype == torch.bfloat16
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {b.dtype for b in tm.buffers()} == {torch.float32}


@pytest.mark.parametrize("cfg", [
    SMALL, MCQ, VAE_SMALL, dict(VAE_SMALL, name="BetaVAE"),
    dict(VAE_SMALL, name="IWAE", num_samples=2),
    dict(VAE_SMALL, name="LVAE", latent_dims=[4, 8])],
    ids=["CTMCQVAE", "MCQVAE", "VanillaVAE", "BetaVAE", "IWAE", "LVAE"])
def test_float64_and_unknown_dtypes_refused(cfg):
    from ctvae_torch.models import build_model
    for dt in ("float64", "float16", "torch.float64"):
        with pytest.raises(NotImplementedError, match="A6"):
            build_model(dict(cfg, dtype=dt), device="cpu")
    assert build_model(dict(cfg, dtype="torch.bfloat16"),
                       device="cpu").compute_dtype == torch.bfloat16


def test_bf16_export_refused(ct_pair):
    """No longer refused: a bfloat16 CT model's ``encode`` exports with a
    symbolic batch, and the program on a batch of 3 equals the live port
    bit for bit in its bfloat16 latents (tests/test_torch_bf16_export.py
    holds every entry point and model)."""
    from ctvae_torch.serving.export import EntryPoint, export_fn
    x, _, _ = batch(1, cfg=SMALL)
    entry = EntryPoint(ct_pair[2], "encode")
    key = torch.zeros((), dtype=torch.int64)
    program = export_fn(entry, (key, torch.from_numpy(x[:2])),
                        poly_batch=True)
    got = program.module()(key, torch.from_numpy(x))
    with torch.inference_mode():
        want = entry(key, torch.from_numpy(x))
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_sharding_over_ranks_refuses_bf16():
    """No longer refused: ``sharding: dp`` and ``fsdp`` over
    ``torch.distributed`` ranks of a bfloat16 model (a gloo world of one
    here) set up and take an action step with finite losses, the CT
    layer's parameters still bfloat16 (two ranks:
    tests/test_torch_bf16_ranks.py)."""
    import socket

    import torch.distributed as dist

    from ctvae_torch.models import build_model
    from ctvae_torch.training.experiment import VAEXperiment
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x, y, a = batch(4, cfg=SMALL)
        for sharding in ("dp", "fsdp"):
            exp = VAEXperiment(build_model(_bf16(SMALL), device="cpu"),
                               dict(EXP, sharding=sharding), None)
            state = exp.setup()
            assert exp.group is not None
            metrics = exp._train_step("action")(state, {
                "image": torch.from_numpy(x), "input_y": torch.from_numpy(y),
                "action": torch.from_numpy(a)})
            assert bool(torch.isfinite(metrics["loss"]))
            assert bool(torch.isfinite(metrics["grad_norm"]))
            assert exp.model.ct_layer.disc_w2.dtype == torch.bfloat16
    finally:
        dist.destroy_process_group()


def test_bench_takes_dtype(monkeypatch, tmp_path, capsys):
    """``python -m ctvae_torch.bench --dtype bfloat16`` builds its models
    at bfloat16 and reports the dtype in its line (the tiers stubbed: the
    full bench at a tiny config is tests/test_torch_bench.py's)."""
    import json

    from ctvae_torch import bench
    seen = []

    def train(p, mode, B, args, device, timer):
        seen.append(p["dtype"])
        return {"ms": 1.0, "scan_ms": 1.0, "device_ms": None,
                "launches": None}
    monkeypatch.setattr(bench, "bench_train", train)
    monkeypatch.setattr(bench, "bench_serve",
                        lambda p, B, args, device, timer: {
                            n: 1.0 for n in bench.SERVE_FNS})
    config = tmp_path / "tiny.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v!r}\n" for k, v in SMALL.items()))
    for dtype in ("bfloat16", "float32"):
        seen.clear()
        assert bench.main(["--config", str(config), "--device", "cpu",
                           "--dtype", dtype]) == 0
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["dtype"] == dtype and seen == [dtype] * 3
