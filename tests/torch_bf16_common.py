"""The helpers that hold the port at ``dtype: bfloat16`` against the JAX
package at bfloat16, shared by tests/test_torch_bf16*.py: the bfloat16
ulp and ``assert_ulps``; ``Taps``, the decisions that bfloat16 rounding
can flip, recorded from JAX and replayed into the port; a train step on
both sides (``_train_step_pair``, with its float32 twin in the port) and
the checks of its gradients and parameters (``assert_bf16_rounding``,
``assert_bf16_step_matches``); and for the model zoo, a pair built at
bfloat16 (``zoo_pair``), the forward and loss on both sides
(``zoo_forward_pair``) and their checks (``assert_zoo_forward``).
tests/test_torch_bf16.py's module doc gives the tolerances and why.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ctvae_torch.convert import from_jax_params
from torch_dp_ranks import TapReplay
from torch_port_common import (SMALL, ReplayDraws, batch,
                               jax_train_step_state, keep_grads,
                               recorded_draws)

ULP = 2.0 ** -8          # one bfloat16 ulp, relative
BF = jnp.bfloat16
EXP = dict(LR=5e-4, weight_decay=0.0)


def _f(a) -> np.ndarray:
    """float64 numpy of a torch tensor (bfloat16 too) or a JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _tb(a) -> torch.Tensor:
    """A bfloat16 tensor of numpy values (through float32: exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def assert_ulps(got, want, ulps: float = 2, scale_ulps: float = 0,
                rel_scale: float = 1e-5, what: str = ""):
    """|got - want| <= ulps ULP |want| + (scale_ulps ULP + rel_scale) x
    max(1, max |want|), elementwise."""
    g, w = _f(got), _f(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
    excess = np.abs(g - w) - ulps * ULP * np.abs(w)
    bound = (scale_ulps * ULP + rel_scale) * scale
    worst = float(excess.max()) if excess.size else 0.0
    assert worst <= bound, (what, worst, bound)


class Taps:
    """The decisions that bfloat16 rounding can flip, recorded from JAX
    and replayed into the port after a check: ``vq`` (a VQ search's
    indices), ``ct`` (``ct_postprocess``'s argmax), ``bern`` (a
    Gumbel-Bernoulli sample) and ``z`` (the bfloat16 values of an
    encoder's heads: ``GaussianHead``'s ``mu`` and ``log_var``, a
    deterministic encoder's ``fc_z`` (WAE_MMD's and SWAE's latent, which
    the decoder takes as it is), BetaTCVAE's ``mu`` and ``log_var`` and
    CategoricalVAE's logits; an element that the two sides' sums round
    to neighbouring bfloat16 values sends the two decoders apart from
    their first layer, and a train pass's BatchNorm spreads that over
    the batch; tapped with ``heads`` only). Each kind is a FIFO in call
    order."""

    def __init__(self, ordered: bool = True, lone: bool = False,
                 heads: bool = False):
        self.rec = {"vq": [], "ct": [], "bern": [], "z": []}
        self.flips = {"vq": 0, "ct": 0, "bern": 0, "z": 0}
        self.ordered, self.lone, self.heads = ordered, lone, heads

    def jax(self, monkeypatch):
        """Tap JAX's decisions. Each tap takes its slot in call order when
        traced and fills it when the program runs, so the callbacks need
        not run in order (``ordered=False``: a step over several devices,
        where JAX takes no ordered effect). With ``lone`` the VQ search
        tapped is a lone ``VectorQuantizerMS``'s (VQVAE's; a
        multi-codebook quantizer calls it too), as one codebook's."""
        from ctvae_tpu.models import ct_vae as jct
        from ctvae_tpu.models import quantizers as jq

        def tap(kind, *arrays):
            slot = len(self.rec[kind])
            self.rec[kind].append(None)

            def fill(*a):
                self.rec[kind][slot] = [
                    np.asarray(x, np.float32) if x.dtype != np.int32
                    else np.asarray(x) for x in a]
            jax.debug.callback(fill, *arrays, ordered=self.ordered)

        vq_cls = (jq.VectorQuantizerMS if self.lone
                  else jq.MultipleCodebookVectorQuantizer)
        orig_ci = vq_cls.compute_inds

        def compute_inds(module, latents):
            inds = orig_ci(module, latents)
            tap("vq", latents.astype(jnp.float32),
                inds[:, None] if self.lone else inds)
            return inds

        orig_pp = jct.CTMCQVAE.ct_postprocess

        def ct_postprocess(module, seq):
            inds = orig_pp(module, seq)
            tap("ct", seq.astype(jnp.float32), inds)
            return inds

        orig_bern = jct.st_bernoulli_gumbel

        def st_bernoulli_gumbel(rng, probs, tau=1.0):
            out = orig_bern(rng, probs, tau)
            tap("bern", jax.lax.stop_gradient(out).astype(jnp.float32))
            return out

        monkeypatch.setattr(vq_cls, "compute_inds", compute_inds)
        monkeypatch.setattr(jct.CTMCQVAE, "ct_postprocess", ct_postprocess)
        monkeypatch.setattr(jct, "st_bernoulli_gumbel", st_bernoulli_gumbel)
        if self.heads:
            self._jax_heads(monkeypatch, tap)

    @staticmethod
    def _jax_heads(monkeypatch, tap):
        """Tap the bfloat16 heads of JAX's encoders (``z``)."""
        from ctvae_tpu.models import backbones as jbb
        from ctvae_tpu.models import betatc_vae as jbtc
        from ctvae_tpu.models import cat_vae as jcat
        from ctvae_tpu.models import gaussian_base as jgb

        def tapped(orig, when):
            def call(module, *a, **k):
                out = orig(module, *a, **k)
                if module.dtype == jnp.bfloat16 and when(module):
                    tap("z", *map(jax.lax.stop_gradient, out))
                return out
            return call

        for cls, name, when in (
                (jgb.StandardGaussianVAE, "encode",
                 lambda m: m.deterministic),
                (jbb.GaussianHead, "__call__", lambda m: True),
                (jbtc.BetaTCVAE, "_encode", lambda m: True),
                (jcat.CategoricalVAE, "encode", lambda m: True)):
            monkeypatch.setattr(cls, name, tapped(getattr(cls, name), when))

    def port(self, monkeypatch):
        """The decisions replayed into the port after their checks
        (``torch_dp_ranks.TapReplay``), flips counted in ``flips``. A
        bfloat16 model's heads (``z``) must be within 2 ulps of each of
        JAX's values (one step of bfloat16's spacing) plus 2 of their
        scale (a head's sum cancels, and its inputs differ by their own
        rounding) and continue at JAX's values, the gradient flowing
        through the port's own; a float32 model (the twin of
        ``_train_step_pair``) keeps its own."""
        TapReplay(self.rec, self.flips, lone=self.lone).install(
            monkeypatch.setattr)
        if not self.heads:
            return
        from ctvae_torch.models.backbones import GaussianHead
        from ctvae_torch.models.betatc_vae import BetaTCVAE
        from ctvae_torch.models.cat_vae import CategoricalVAE
        from ctvae_torch.models.gaussian_base import StandardGaussianVAE

        def replay(out, bf16):
            assert self.rec["z"], "a head that JAX did not tap"
            want = self.rec["z"].pop(0)
            if not bf16:
                return out
            got = []
            for t, w in zip(out, want):
                w = torch.from_numpy(np.array(w))
                assert_ulps(t, w, scale_ulps=2, what="z")
                self.flips["z"] += int((t != w).sum())
                got.append(t + (w - t).detach())
            return got

        def replayed(orig, when, dtype, kind=list):
            def call(module, *a, **k):
                out = orig(module, *a, **k)
                if not when(module):
                    return out
                return kind(replay(out, dtype(module) == torch.bfloat16))
            return call

        for cls, name, when, dtype, kind in (
                (StandardGaussianVAE, "encode", lambda m: m.deterministic,
                 lambda m: m.compute_dtype, list),
                (GaussianHead, "forward", lambda m: True,
                 lambda m: m.fc_mu.compute_dtype, tuple),
                (BetaTCVAE, "encode", lambda m: True,
                 lambda m: m.compute_dtype, list),
                (CategoricalVAE, "encode", lambda m: True,
                 lambda m: m.compute_dtype, list)):
            monkeypatch.setattr(cls, name, replayed(getattr(cls, name), when,
                                                    dtype, kind))

    def done(self) -> bool:
        return not any(self.rec.values())


def jax_step_of(jm, variables, mode, b, monkeypatch, seed, exp, M_N=1.0,
                step=0, optimizer_idx=0,
                fwd_kwargs_keys=("action", "input_y")):
    """``torch_port_common.jax_train_step_state`` for ``optimizer_idx`` 0;
    for another, the step of that optimizer of every one ``exp`` builds
    (each behind ``keep_grads``): (params, that optimizer's gradients,
    metrics, draws, model state)."""
    if optimizer_idx == 0:
        return jax_train_step_state(jm, variables, mode, b, monkeypatch,
                                    seed, exp, M_N=M_N, step=step,
                                    fwd_kwargs_keys=fwd_kwargs_keys)
    import optax

    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    params = variables["params"]
    txs = [optax.chain(keep_grads(), tx)
           for tx in jopt.build_optimizers(exp, params, 4)]
    state = jstate.TrainState(
        step=jnp.array(step, jnp.int32), params=params,
        model_state={k: v for k, v in variables.items() if k != "params"},
        opt_states=tuple(tx.init(params) for tx in txs),
        rng=jax.random.PRNGKey(seed))
    step_fn = jax.jit(jstate.make_train_step(
        jm, txs, M_N=M_N, optimizer_idx=optimizer_idx,
        fwd_kwargs_keys=fwd_kwargs_keys, static_fwd_kwargs={"mode": mode}))
    with recorded_draws(monkeypatch, seed=seed) as rec:
        new, metrics = step_fn(state, b)
    return (jax.device_get(new.params),
            jax.device_get(new.opt_states[optimizer_idx][0]),
            jax.device_get(metrics), rec.draws,
            jax.device_get(new.model_state))


def _train_step_pair(monkeypatch, pair, mode, cfg, exp=EXP, twin=True, *,
                     b=None, M_N=1.0, step=0, optimizer_idx=0, build=None,
                     heads=False):
    """One train step of ``mode`` in JAX and in the port from the same
    params, draws and tapped decisions. Returns (JAX params, grads,
    metrics, model state), (port model, metrics) and, under ``twin``,
    (port model, metrics) of the same step at float32: the port built at
    float32 from the bfloat16 model's values (exact), on the same draws
    and JAX's decisions, the reference that ``assert_bf16_step_matches``
    measures both bfloat16 steps' rounding against.

    ``b`` is the batch of numpy arrays (by default images, ``input_y``
    and actions of ``cfg``'s size; a batch with ``labels`` passes them to
    the forward), ``M_N`` the step's KL weight, ``step`` the state's
    global step, ``optimizer_idx`` the optimizer whose step it is
    (FactorVAE's discriminator: 1), ``build(cfg)`` makes the float32
    twin where ``build_model`` does not (TwoStageVAE), and ``heads`` taps
    the encoder's heads too (``Taps``)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    jm, variables, tm0 = pair
    if b is None:
        x, y, a = batch(11, cfg=dict(SMALL, img_size=cfg["img_size"]))
        b = {"image": x, "input_y": y, "action": a}
    fwd = ("labels",) if "labels" in b else ("action", "input_y")
    lone = type(tm0).__name__ == "VQVAE"
    taps = Taps(lone=lone, heads=heads)
    with monkeypatch.context() as m:
        taps.jax(m)
        j_params, j_grads, j_metrics, draws, j_state = jax_step_of(
            jm, variables, mode, {k: jnp.asarray(v) for k, v in b.items()},
            m, seed=12, exp=exp, M_N=M_N, step=step,
            optimizer_idx=optimizer_idx, fwd_kwargs_keys=fwd)

    def port_step(tm, taps):
        replay = ReplayDraws(draws)
        with monkeypatch.context() as m:
            taps.port(m)
            m.setattr(tstate, "Draws", lambda gen, device: replay)
            state = tstate.create_train_state(
                tm, topt.build_optimizers(exp, tm, 4))
            state.step = step
            metrics = tstate.make_train_step(
                mode, M_N=M_N, optimizer_idx=optimizer_idx)(
                state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert replay.done() and taps.done() and state.step == step + 1
        return tm, metrics

    twin_taps = Taps(lone=lone, heads=heads)
    twin_taps.rec = copy.deepcopy(taps.rec)
    out = ((j_params, j_grads, j_metrics, j_state),
           port_step(copy.deepcopy(tm0), taps))
    if not twin:
        return out
    tm32 = (build or functools.partial(build_model, device="cpu"))(
        dict(cfg, dtype="float32"))
    tm32.load_state_dict({k: v.float() if v.is_floating_point() else v
                          for k, v in tm0.state_dict().items()})
    return out + (port_step(tm32, twin_taps),)


def _grad(p: torch.Tensor) -> torch.Tensor:
    return (p.grad if p.grad is not None else torch.zeros_like(p)).double()


def assert_bf16_rounding(got, jax_value, ref, what, ulps=2):
    """The port's bfloat16 value ``got`` no further from the float32
    reference ``ref`` than twice JAX's bfloat16 value is, plus ``ulps``
    bfloat16 ulps of the reference (in the 2-norm)."""
    g, w, r = (torch.as_tensor(_f(v)) for v in (got, jax_value, ref))
    e_port, e_jax = float((g - r).norm()), float((w - r).norm())
    assert e_port <= 2 * e_jax + ulps * ULP * float(r.norm()), \
        (what, e_port, e_jax, float(r.norm()))


def assert_bf16_step_matches(tm, tm32, j_params, j_grads, lr):
    """The gradients and the parameters after Adam's first step against
    JAX's, every leaf alike (conv, Dense, codebook, BatchNorm, CT layer).

    Two bfloat16 steps round differently, and the rounding is amplified
    wherever a gradient is a sum that cancels (the pairwise scores' bias,
    a GAT layer's ``lin_r`` under the softmax, a conv bias right before a
    BatchNorm, whose exact gradient is zero), so the two are not within a
    few ulps of each other: the port at float32 (``tm32``, the same step
    on the same values, draws and decisions; held against JAX at float32
    by tests/test_torch_training.py) is the reference. Each leaf of the
    port's bfloat16 gradient must be within twice the distance of JAX's
    bfloat16 gradient to it, plus 2 ulps of its norm
    (``assert_bf16_rounding``): the port's bfloat16 step is as accurate as
    JAX's. That also covers JAX on the CPU summing a bfloat16
    convolution's bias and weight gradients in a bfloat16 accumulator,
    which stalls once the terms fall below its ulp (a ``ConvTranspose``
    bias gradient of 4.0 where 768 terms sum to 7.68): the port sums in
    float32 and is the closer of the two.

    Adam's first step moves a parameter by ``lr g / (|g| + 1e-8)``, by
    the gradient's sign: each parameter after the step within 2 ulps of
    JAX's plus 2e-6 and ``lr`` times the difference of the two sides'
    ``g / (|g| + 1e-8)``. The two signs may differ only on an element
    whose float32 gradient is within twice JAX's largest deviation from it
    in that leaf of zero, where bfloat16 rounding alone can flip it."""
    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    ref = dict(tm32.named_parameters())
    for name, p in tm.named_parameters():
        assert want_g[name].dtype == p.dtype, name
        assert p.grad is None or p.grad.dtype == p.dtype, name
        g, w, r = _grad(p), want_g[name].double(), _grad(ref[name])
        assert_bf16_rounding(g, w, r, name)
        flip = torch.sign(g) != torch.sign(w)
        noise = 2 * float((w - r).abs().max())
        assert not bool((flip & (r.abs() > noise)).any()), name
        step = (g / (g.abs() + 1e-8) - w / (w.abs() + 1e-8)).abs()
        q = want_p[name].double()
        tol = 2 * ULP * q.abs() + 2e-6 + lr * step
        assert bool(((p.detach().double() - q).abs() <= tol).all()), name


# --- the model zoo -----------------------------------------------------------

def zoo_rngs():
    """The forward's streams (the recorder replaces what they draw)."""
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    return dict(zip(("reparam", "gumbel", "noise", "dropout"), keys))


def zoo_pair(cfg, x, labels=None, jax_build=None, port_build=None):
    """(JAX model, its variables, the port's model on the CPU with them)
    of ``cfg`` at ``dtype: bfloat16``, initialised on ``x`` (and
    ``labels``); ``jax_build`` / ``port_build`` make a model that is in
    no registry (TwoStageVAE)."""
    from ctvae_torch.models import build_model
    from ctvae_tpu.models import build_model as jax_registry
    cfg = dict(cfg, dtype="bfloat16")
    jm = (jax_build or jax_registry)(dict(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    lab = () if labels is None else (jnp.asarray(labels),)
    variables = jax.device_get(jax.jit(
        lambda r, x, *lab: jm.init(r, x, *lab, train=False))(
        dict(zip(("params", "reparam", "gumbel", "noise", "dropout"),
                 keys)), jnp.asarray(x), *lab))
    tm = (port_build or functools.partial(build_model, device="cpu"))(cfg)
    tm.load_state_dict(from_jax_params(variables, tm))
    assert tm.compute_dtype == torch.bfloat16
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {b.dtype for b in tm.buffers()} <= {torch.float32}
    return jm, variables, tm


def zoo_forward_pair(monkeypatch, pair, x, train, *, labels=None, step=0,
                     M_N=0.5, idxs=(0,), seed=14):
    """The forward of ``x`` (and ``labels``) at ``train`` and
    ``loss_function`` at ``M_N``, the global ``step`` and each optimizer
    index of ``idxs``, in JAX (jitted) and in a copy of the port's model,
    every draw recorded on the JAX side and replayed and the heads'
    bfloat16 values tapped (``Taps``): (JAX outputs, JAX losses, port
    outputs, port losses)."""
    jm, variables, tm = pair
    tm = copy.deepcopy(tm)   # a train pass folds BatchNorm's statistics
    lab = () if labels is None else (labels,)
    jstep = jnp.asarray(step, jnp.int32)

    def fwd(v, x, *lab):
        out = jm.apply(v, x, *lab, train=train, rngs=zoo_rngs(), step=jstep,
                       mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return out, [jm.loss_function(out, M_N=M_N, step=jstep, train=train,
                                      optimizer_idx=i,
                                      rng=jax.random.PRNGKey(7))
                     for i in idxs]
    taps = Taps(heads=True)
    with monkeypatch.context() as m:
        taps.jax(m)
        with recorded_draws(m, seed=seed) as rec:
            want, want_losses = jax.jit(fwd)(
                variables, jnp.asarray(x), *map(jnp.asarray, lab))
        # dispatch is asynchronous: a gamma slot is filled when JAX has run
        want, want_losses = jax.device_get((want, want_losses))
    replay = ReplayDraws(rec.draws)
    tstep = torch.tensor(step)
    with torch.no_grad(), monkeypatch.context() as m:
        taps.port(m)
        got = tm(torch.from_numpy(x), *map(torch.from_numpy, lab),
                 train=train, draws=replay, step=tstep)
        got_losses = [tm.loss_function(got, M_N=M_N, step=tstep,
                                       train=train, optimizer_idx=i,
                                       draws=replay) for i in idxs]
    assert replay.done() and taps.done()
    return want, want_losses, got, got_losses


def assert_zoo_forward(want, want_losses, got, got_losses):
    """Every output of the forward but its input in float32 on both sides
    and within 4 ulps of its scale (a list, as DFCVAE's feature taps,
    element by element); every loss term within 5 ulps (2 %)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "input":
            continue
        pairs = (zip(got[k], w) if isinstance(w, (list, tuple))
                 else [(got[k], w)])
        for g, wi in pairs:
            assert g.dtype == torch.float32 and wi.dtype == np.float32, k
            assert_ulps(g, wi, ulps=0, scale_ulps=4, what=k)
    for loss, j_loss in zip(got_losses, want_losses):
        assert set(loss) == set(j_loss)
        for k, v in j_loss.items():
            assert_ulps(loss[k], v, ulps=5, what=k)


def assert_zoo_step(step_pair, lr):
    """A ``_train_step_pair``'s result: every metric within 5 ulps (2 %),
    ``grad_norm`` and every gradient leaf and parameter after Adam
    (``assert_bf16_step_matches``), and each BatchNorm buffer in float32
    within 4 ulps of its scale of JAX's."""
    (j_params, j_grads, j_metrics, j_state), (tm, metrics), (tm32, m32) = \
        step_pair
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        if k != "grad_norm":
            assert_ulps(metrics[k], v, ulps=5, what=k)
    assert_bf16_rounding(metrics["grad_norm"], j_metrics["grad_norm"],
                         m32["grad_norm"], "grad_norm")
    assert_bf16_step_matches(tm, tm32, j_params, j_grads, lr)
    want = from_jax_params({"params": j_params, **j_state}, tm)
    for name, buf in tm.named_buffers():
        assert buf.dtype == torch.float32, name
        assert_ulps(buf, want[name], ulps=0, scale_ulps=4, what=name)
