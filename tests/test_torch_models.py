"""The port's models (ctvae_torch/models) against the JAX package at small
widths, with JAX weights converted by ``from_jax_params`` and the JAX
random draws replayed into the port (tests/torch_port_common.py).

Tolerance: atol 1e-5 / rtol 1e-4 on values; indices, hard Gumbel samples
and argmax outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_tpu.models.backbones import VQDecoder as JVQDecoder
from ctvae_tpu.models.backbones import VQEncoder as JVQEncoder
from ctvae_tpu.models.ct_vae import CausalTransition as JCausalTransition
from ctvae_tpu.models.quantizers import (
    MultipleCodebookVectorQuantizer as JMCQ, codebook_perplexity as j_perp)
from ctvae_torch.convert import from_jax_params
from ctvae_torch.models.base import Draws
from ctvae_torch.models.backbones import VQDecoder, VQEncoder
from ctvae_torch.models.ct_vae import CausalTransition
from ctvae_torch.models.quantizers import (
    MultipleCodebookVectorQuantizer, codebook_perplexity)
from torch_port_common import (SMALL, ReplayDraws, batch, build_pair, close,
                               jax_rngs, recorded_draws, t2n)


def test_vq_backbones_match_jax():
    hd, D = (8, 16), 8
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    jenc, jdec = JVQEncoder(hd, D), JVQDecoder(hd, out_channels=3)
    ve = jenc.init(jax_rngs(0), jnp.asarray(x))
    lat = jenc.apply(ve, jnp.asarray(x))
    vd = jdec.init(jax_rngs(1), lat)
    enc, dec = VQEncoder(3, hd, D, device="cpu"), VQDecoder(D, hd, 3,
                                                            device="cpu")
    enc.load_state_dict(from_jax_params(ve, enc))
    dec.load_state_dict(from_jax_params(vd, dec))
    with torch.no_grad():
        t_lat = enc(torch.from_numpy(x))
        t_dec = dec(torch.from_numpy(np.array(lat)))
    close(t2n(t_lat), lat)
    close(t2n(t_dec), jdec.apply(vd, lat))


@pytest.mark.parametrize("slicing", ["chunk", "overlap"])
def test_quantizer_matches_jax(slicing):
    K, D, C = 8, 8, 2
    rng = np.random.default_rng(1)
    lat = rng.normal(scale=0.2, size=(3, 4, 4, D)).astype(np.float32)
    jq = JMCQ(K, D, C, 0.1, slicing=slicing)
    v = jq.init(jax_rngs(1), jnp.asarray(lat))
    tq = MultipleCodebookVectorQuantizer(K, D, C, 0.1, slicing=slicing,
                                         device="cpu")
    tq.load_state_dict(from_jax_params(v, tq))
    j_inds = jq.apply(v, jnp.asarray(lat), method=jq.compute_inds)
    # decode through other indices than the nearest ones, as the CT does
    use = np.asarray(j_inds)[:, ::-1].copy()
    j_q, j_loss = jq.apply(v, jnp.asarray(lat), jnp.asarray(use),
                           method=jq.compute_latents)
    with torch.no_grad():
        t_inds = tq.compute_inds(torch.from_numpy(lat))
        t_q, t_loss = tq.compute_latents(torch.from_numpy(lat),
                                         torch.from_numpy(use).long())
    np.testing.assert_array_equal(t2n(t_inds), np.asarray(j_inds))
    close(t2n(t_q), j_q)
    close(t2n(t_loss), j_loss)
    close(t2n(codebook_perplexity(t_inds, K)), j_perp(j_inds, K))


def _ct_pair(seed):
    N, A = SMALL["num_embeddings"], SMALL["action_dim"]
    jct = JCausalTransition(input_dim=N, action_dim=A, latent_dims=(16, 8),
                            c_alpha=0.3, c_beta=0.4, c_delta=0.2,
                            c_epsilon=0.1)
    rng = np.random.default_rng(seed)
    B, S = 3, 8
    lat = np.eye(N, dtype=np.float32)[rng.integers(0, N, (B, S))]
    lat_y = np.eye(N, dtype=np.float32)[rng.integers(0, N, (B, S))]
    act = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    v = jax.jit(lambda r, *a: jct.init(r, *a, method=jct.forward_action))(
        jax_rngs(seed), jnp.asarray(lat), jnp.asarray(act))
    tct = CausalTransition(N, A, (16, 8), c_alpha=0.3, c_beta=0.4,
                           c_delta=0.2, c_epsilon=0.1, device="cpu")
    tct.load_state_dict(from_jax_params(v, tct))
    return jct, v, tct, lat, lat_y, act


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_causal_transition_matches_jax(monkeypatch, mode):
    jct, v, tct, lat, lat_y, act = _ct_pair(2)
    args = {"base": (lat,), "action": (lat, act),
            "causal": (lat, lat_y)}[mode]
    method = {"base": "__call__", "action": "forward_action",
              "causal": "forward_transition"}[mode]
    run = jax.jit(lambda v, *a: jct.apply(v, *a, train=False,
                                          rngs=jax_rngs(4), method=method))
    with recorded_draws(monkeypatch, seed=3) as rec:
        j_y, j_reg, j_met = run(v, *map(jnp.asarray, args))
    draws = ReplayDraws(rec.draws)
    t_method = {"base": tct.forward, "action": tct.forward_action,
                "causal": tct.forward_transition}[mode]
    with torch.no_grad():
        t_y, t_reg, t_met = t_method(*map(torch.from_numpy, args), draws)
    assert draws.done()
    close(t2n(t_y), j_y)
    close(t2n(t_reg), j_reg)
    assert set(t_met) == set(j_met)
    for k in j_met:
        close(t2n(t_met[k]), j_met[k])


def _run_jax(jm, variables, monkeypatch, mode, x, y, a, seed):
    kwargs = {"base": {}, "action": dict(input_y=y, action=a),
              "causal": dict(input_y=y, action=a)}[mode]

    @jax.jit
    def run(variables, x, kwargs):
        out = jm.apply(variables, x, mode=mode, train=False,
                       rngs=jax_rngs(seed), **kwargs)
        losses = jm.apply(variables, out, method=jm.loss_function)
        del out["mode"]          # a string: not an output of a jitted fn
        return out, losses

    with recorded_draws(monkeypatch, seed=seed) as rec:
        out, losses = run(variables, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in kwargs.items()})
    return out, losses, rec.draws


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_ctmcqvae_matches_jax(monkeypatch, mode):
    jm, variables, tm = build_pair(seed=0)
    x, y, a = batch(5)
    j_out, j_loss, rec = _run_jax(jm, variables, monkeypatch, mode, x, y, a,
                                  seed=6)
    draws = ReplayDraws(rec)
    with torch.no_grad():
        t_out = tm(torch.from_numpy(x), input_y=torch.from_numpy(y),
                   action=torch.from_numpy(a), mode=mode, draws=draws)
        t_loss = tm.loss_function(t_out)
    assert draws.done()
    close(t2n(t_out["recons"]), j_out["recons"])
    for k in ("ct_loss", "vq_loss"):
        close(t2n(t_out[k]), j_out[k])
    assert set(t_out["metrics"]) == set(j_out["metrics"])
    for k, v in j_out["metrics"].items():
        close(t2n(t_out["metrics"][k]), v)
    for k in ("loss", "Reconstruction_Loss", "VQ_Loss", "CT_Loss"):
        close(t2n(t_loss[k]), j_loss[k])
    # the quantizer's indices (exact) on both encoder inputs
    j_inds = jax.jit(lambda v, z: jm.apply(
        v, z, method=lambda m, z: m.vq_layer.compute_inds(m.encoder(z))))(
            variables, jnp.asarray(np.concatenate([x, y])))
    with torch.no_grad():
        t_inds = tm.vq_layer.compute_inds(
            tm.encoder(torch.from_numpy(np.concatenate([x, y]))))
    np.testing.assert_array_equal(t2n(t_inds), np.asarray(j_inds))


def test_unsupported_options_raise():
    from ctvae_torch.models import build_model
    for extra in (dict(ema=True), dict(grad_estimator="rotation"),
                  dict(pairwise_block_rows=8), dict(gat_block_cols=8),
                  dict(seq_axis="model"), dict(noise="exo")):
        with pytest.raises(NotImplementedError):
            build_model({**SMALL, **extra}, device="cpu")
    # train=True is ported (the training slice): it runs, and its PE
    # dropout makes the base forward depend on the draws
    tm = build_model(dict(SMALL), device="cpu")
    x, _, _ = batch(0)
    outs = [tm(torch.from_numpy(x), mode="base", train=True,
               draws=Draws(torch.Generator().manual_seed(s)))["ct_loss"]
            for s in (0, 1)]
    assert all(torch.isfinite(o) for o in outs) and outs[0] != outs[1]


def test_build_model_init_ranges_match_flax():
    """flax-like init: each kernel's spread matches the JAX init's."""
    from ctvae_torch.models import build_model
    jm, variables, _ = build_pair(seed=0)
    tm = build_model(dict(SMALL), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    jflat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    tparams = dict(tm.named_parameters())
    for path, leaf in jflat:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel"
                                     else keys[-1]])
        j_std = float(np.std(np.asarray(leaf)))
        t_std = float(tparams[name].detach().std(unbiased=False))
        if leaf.size < 64 or j_std == 0.0:
            assert (j_std == 0.0) == (t_std == 0.0) or leaf.size < 64, name
            continue
        assert 0.5 < t_std / j_std < 2.0, (name, t_std, j_std)
