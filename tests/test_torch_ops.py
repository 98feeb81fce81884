"""The port's plain ops (ctvae_torch/ops) against their JAX counterparts:
the XLA forms and the Pallas kernels in interpret mode.

Tolerance: atol 1e-5 / rtol 1e-4 on values (f32 on both sides, sums taken
in another order); indices and masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_tpu.ops import gat as jgat
from ctvae_tpu.ops.gat_flash import flash_gat as j_flash_gat
from ctvae_tpu.ops.pairwise import fused_pairwise_scores as j_fused_pairwise
from ctvae_tpu.ops.pairwise_flash import flash_pairwise as j_flash_pairwise
from ctvae_tpu.ops.vq import l2_argmin_pallas, l2_argmin_xla
from ctvae_torch.convert import from_jax_params
from ctvae_torch.ops import gat as tgat
from ctvae_torch.ops.gat_flash import flash_gat, flash_gat_plain
from ctvae_torch.ops.pairwise import fused_pairwise_scores, pairwise_mlp_scores
from ctvae_torch.ops.pairwise_flash import flash_pairwise
from ctvae_torch.ops.vq import l2_argmin, l2_argmin_plain
from torch_port_common import close, jax_rngs, t2n


@pytest.mark.parametrize("n,k,d", [(37, 8, 4), (300, 64, 16)])
def test_vq_plain_matches_xla_and_pallas(n, k, d):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    # a duplicated code: ties must go to the first index
    cb[5] = cb[2]
    x[:3] = cb[2]
    ours = t2n(l2_argmin_plain(torch.from_numpy(x), torch.from_numpy(cb)))
    np.testing.assert_array_equal(ours, np.asarray(
        l2_argmin_xla(jnp.asarray(x), jnp.asarray(cb))))
    np.testing.assert_array_equal(ours, np.asarray(
        l2_argmin_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True)))
    assert (ours[:3] == 2).all()
    # the dispatching wrapper takes the plain path on CPU tensors
    np.testing.assert_array_equal(
        t2n(l2_argmin(torch.from_numpy(x), torch.from_numpy(cb))), ours)


def _pairwise_inputs(seed, B, S, T, H, per_sample):
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(B, S, H)).astype(np.float32)
    xr = rng.normal(size=(B, T, H)).astype(np.float32)
    if per_sample:
        w2 = rng.normal(size=(B, H)).astype(np.float32)
        b1 = rng.normal(size=(B, H)).astype(np.float32)
        b2 = rng.normal(size=(B,)).astype(np.float32)
    else:
        w2 = rng.normal(size=(H,)).astype(np.float32)
        b1 = rng.normal(size=(H,)).astype(np.float32)
        b2 = np.float32(rng.normal())
    return xl, xr, w2, b1, np.asarray(b2, np.float32)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("S,T", [(7, 7), (9, 5)])
def test_pairwise_plain_matches_xla_and_pallas(per_sample, S, T):
    args = _pairwise_inputs(S * 10 + T, 3, S, T, 24, per_sample)
    ours = t2n(fused_pairwise_scores(*map(torch.from_numpy, args), 0.01))
    jargs = tuple(map(jnp.asarray, args))
    close(ours, j_fused_pairwise(*jargs, 0.01))
    # the Pallas kernel takes per-sample [B, H] params (the JAX caller
    # broadcasts w2); interpret mode on the CPU
    B, H = args[0].shape[0], args[0].shape[2]
    w2b = jnp.broadcast_to(jargs[2], (B, H))
    close(ours, j_flash_pairwise(jargs[0], jargs[1], w2b, jargs[3], jargs[4],
                                 0.01, True))
    # the kernel wrapper and the discoverer entry take the plain path on CPU
    close(t2n(flash_pairwise(*map(torch.from_numpy, args), 0.01)), ours,
          atol=0, rtol=0)
    xl, xr, w2, b1, b2 = map(torch.from_numpy, args)
    if S == T:
        close(t2n(pairwise_mlp_scores(xl, xr, w2, b2, b1)), ours,
              atol=0, rtol=0)


def test_pairwise_block_rows_not_ported():
    xl = torch.zeros(1, 4, 3)
    with pytest.raises(NotImplementedError):
        pairwise_mlp_scores(xl, xl, torch.zeros(3), torch.zeros(()),
                            torch.zeros(3), block_rows=2)


def _gat_layer_pair(fin, F, H, seed):
    layer = jgat.DenseGATv2Layer(F, heads=H)
    x0 = jnp.zeros((1, 3, fin))
    variables = layer.init(jax_rngs(seed), x0, jnp.zeros((1, 3, 3)))
    ours = tgat.DenseGATv2Layer(fin, F, heads=H, device="cpu")
    ours.load_state_dict(from_jax_params(variables, ours))
    return layer, variables, ours


def _adjacency(rng, B, T, edgeless_col=None):
    adj = rng.uniform(size=(B, T, T)).astype(np.float32)
    adj[rng.uniform(size=adj.shape) < 0.4] = 0.0   # sampled-away edges
    if edgeless_col is not None:
        adj[:, :, edgeless_col] = 0.0
    return adj


@pytest.mark.parametrize("flash", ["1", "0"])
def test_gat_layer_matches_jax(monkeypatch, flash):
    """DenseGATv2Layer.__call__ against the JAX layer routed through the
    Pallas kernel (interpret mode) and through the XLA path."""
    monkeypatch.setenv("CTVAE_FLASH_GAT", flash)
    B, T, fin, F, H = 3, 7, 5, 4, 3
    layer, variables, ours = _gat_layer_pair(fin, F, H, 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, fin)).astype(np.float32)
    adj = _adjacency(rng, B, T, edgeless_col=2)
    want = layer.apply(variables, jnp.asarray(x), jnp.asarray(adj))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(adj))
    close(t2n(got), want)


def test_gat_heads_and_identity_calls_match_jax():
    B, T, fin, F, H = 3, 6, 5, 4, 3
    layer, variables, ours = _gat_layer_pair(fin, F, H, 2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, fin)).astype(np.float32)
    adj = _adjacency(rng, B, T)
    head_idx = np.array([[0, 1], [0, 2], [2, 2]], np.int32)
    want = layer.apply(variables, jnp.asarray(x), jnp.asarray(adj),
                       jnp.asarray(head_idx), method=layer.heads_call)
    want_id = layer.apply(variables, jnp.asarray(x),
                          method=layer.identity_call)
    with torch.no_grad():
        got = ours.heads_call(torch.from_numpy(x), torch.from_numpy(adj),
                              torch.from_numpy(head_idx).long())
        got_id = ours.identity_call(torch.from_numpy(x))
    close(t2n(got), want)
    close(t2n(got_id), want_id)


def test_replace_self_loops_matches_jax():
    rng = np.random.default_rng(4)
    adj = _adjacency(rng, 2, 6, edgeless_col=1)
    layer = jgat.DenseGATv2Layer(4, heads=1)
    j_adj, j_mask = layer._replace_self_loops(jnp.asarray(adj))
    t_adj, t_mask = tgat.replace_self_loops(torch.from_numpy(adj))
    close(t2n(t_adj), j_adj)
    np.testing.assert_array_equal(t2n(t_mask), np.asarray(j_mask))


def test_flash_gat_plain_matches_pallas_with_edgeless_target():
    """The kernel's plain version against the Pallas forward (interpret)
    on a mask whose target column 3 has no incoming edge (zero row) and a
    ragged T."""
    B, S, H, F = 2, 9, 3, 5
    rng = np.random.default_rng(5)
    xl = rng.normal(size=(B, S, H, F)).astype(np.float32)
    xr = rng.normal(size=(B, S, H, F)).astype(np.float32)
    adj = rng.uniform(size=(B, S, S)).astype(np.float32)
    mask = rng.uniform(size=(B, S, S)) < 0.6
    mask[:, :, 3] = False
    we = rng.normal(size=(H, F)).astype(np.float32)
    att = rng.normal(size=(H, F)).astype(np.float32)
    ours = flash_gat_plain(*map(torch.from_numpy, (xl, xr, adj, mask, we,
                                                   att)), 0.2)
    want = j_flash_gat(*map(jnp.asarray, (xl, xr, adj, mask, we, att)), 0.2,
                       True)
    close(t2n(ours), want)
    assert not t2n(ours)[:, 3].any()
    # masked softmax alone, against the JAX layer's
    logits = rng.normal(size=(B, S, S, H)).astype(np.float32)
    close(t2n(tgat.masked_incoming_softmax(torch.from_numpy(logits),
                                           torch.from_numpy(mask))),
          jgat.DenseGATv2Layer._masked_incoming_softmax(
              jnp.asarray(logits), jnp.asarray(mask)))
    close(t2n(flash_gat(*map(torch.from_numpy, (xl, xr, adj, mask, we, att)),
                        0.2)), t2n(ours), atol=0, rtol=0)


def test_gat_stack_matches_jax():
    """GATv2Stack.select_forward / identity_forward with converted weights."""
    N, H, hidden = 6, 3, (5,)
    stack = jgat.GATv2Stack(input_dim=N, hidden=hidden, heads=H)
    B, T = 2, 7
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, N)).astype(np.float32)
    adj = _adjacency(rng, B, T)
    head_idx = np.array([[0, 2], [0, 1]], np.int32)
    variables = stack.init(jax_rngs(6), jnp.asarray(x), jnp.asarray(adj),
                           jnp.asarray(head_idx), method=stack.select_forward)
    ours = tgat.GATv2Stack(N, hidden, H, device="cpu")
    ours.load_state_dict(from_jax_params(variables, ours))
    want = stack.apply(variables, jnp.asarray(x), jnp.asarray(adj),
                       jnp.asarray(head_idx), method=stack.select_forward)
    want_id = stack.apply(variables, jnp.asarray(x),
                          method=stack.identity_forward)
    with torch.no_grad():
        got = ours.select_forward(torch.from_numpy(x), torch.from_numpy(adj),
                                  torch.from_numpy(head_idx).long())
        got_id = ours.identity_forward(torch.from_numpy(x))
    close(t2n(got), want)
    close(t2n(got_id), want_id)


# --- gradients (the training slice) ---------------------------------------
# Tolerance of the gradient cases: atol 1e-5 / rtol 1e-4 (f32, sums of up
# to a few hundred terms in another order on the two sides).

def _grad_close(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(t2n(g), w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("S,T", [(7, 7), (9, 5)])
def test_flash_pairwise_grads_match_pallas(per_sample, S, T):
    """FlashPairwise's plain path (autograd through the plain version)
    against ``jax.grad`` of the Pallas kernel's custom VJP, interpret mode:
    shared params get the batch sum, per-sample params their own rows."""
    import jax
    args = _pairwise_inputs(S * 10 + T + 1, 3, S, T, 24, per_sample)
    dout = np.random.default_rng(S + T).normal(size=(3, S, T)).astype(
        np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_flash_pairwise(*a, 0.01, True)
                                       * dout), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(flash_pairwise(*leaves, 0.01), leaves,
                              torch.from_numpy(dout))
    _grad_close(got, want)


@pytest.mark.parametrize("S,T", [(9, 9), (8, 5)])
def test_flash_gat_grads_match_pallas(S, T):
    """FlashGAT's plain path against ``jax.grad`` of the Pallas kernel's
    custom VJP (interpret mode), with an edgeless target and S != T."""
    import jax
    B, H, F = 2, 3, 5
    rng = np.random.default_rng(S * T)
    xl = rng.normal(size=(B, S, H, F)).astype(np.float32)
    xr = rng.normal(size=(B, T, H, F)).astype(np.float32)
    mask = rng.uniform(size=(B, S, T)) < 0.6
    mask[:, :, 3] = False
    adj = (rng.uniform(size=(B, S, T)) * mask).astype(np.float32)
    we = rng.normal(size=(H, F)).astype(np.float32)
    att = rng.normal(size=(H, F)).astype(np.float32)
    dout = rng.normal(size=(B, T, H, F)).astype(np.float32)

    def jloss(xl, xr, adj, we, att):
        return jnp.sum(j_flash_gat(xl, xr, adj, jnp.asarray(mask), we, att,
                                   0.2, True) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xl, xr, adj, we, att)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (xl, xr, adj, we, att)]
    out = flash_gat(leaves[0], leaves[1], leaves[2], torch.from_numpy(mask),
                    leaves[3], leaves[4], 0.2)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    _grad_close(got, want)
    assert not t2n(got[1])[:, 3].any()


def _grad_fns(fn):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is not None and f not in seen:
            seen.add(f)
            todo += [g for g, _ in f.next_functions]
    return {type(f).__name__ for f in seen}


def test_masked_softmax_max_gets_no_gradient():
    """The softmax max is a constant of the gradient (JAX's
    ``stop_gradient``): no ``amax`` node on the autograd graph, and the
    gradient at tied maxima equals JAX's."""
    import jax
    rng = np.random.default_rng(7)
    B, S, H = 2, 6, 3
    logits = rng.normal(size=(B, S, S, H)).astype(np.float32)
    logits[:, 1] = logits[:, 4] = 3.0          # tied maxima over sources
    mask = rng.uniform(size=(B, S, S)) < 0.7
    mask[:, 1] = mask[:, 4] = True
    c = rng.normal(size=logits.shape).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(
        jgat.DenseGATv2Layer._masked_incoming_softmax(z, jnp.asarray(mask))
        * c))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    alpha = tgat.masked_incoming_softmax(z, torch.from_numpy(mask))
    assert not any(n.startswith("Amax") for n in _grad_fns(alpha.grad_fn))
    (got,) = torch.autograd.grad(alpha, z, torch.from_numpy(c))
    close(t2n(got), want, atol=1e-7, rtol=1e-6)
