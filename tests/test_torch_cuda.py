"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit: it is marked
``cuda`` and skips without a card. On a machine with one (it needs no
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and ragged (odd S and T, F not a multiple of 32, K above
one warp) to reach the kernels' edges. Tolerances: atol 1e-5 for the
pairwise scores, 1e-5 / rtol 1e-4 for the GAT output (f32, sums in
another order); VQ indices exactly, on inputs without near-ties.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy(np.asarray(
        rng.normal(size=shape) * scale, np.float32)).cuda()


@pytest.mark.parametrize("n,k,d", [
    (37, 8, 4), (1000, 64, 128), (5, 70, 33),
    # codebooks: 2 and 4 split the headline's 128 into D = 64 and 32
    (1024, 64, 64), (1024, 64, 32),
    # several 64-code passes and 128-float chunks of D, D % 4 != 0
    (300, 130, 300), (40, 65, 257),
    # the search's codebooks of 16 and 32 codes (less than one pass) at
    # B = 8 (512 rows) and D = 128 / 64 (codebooks 1 / 2)
    (512, 16, 128), (512, 32, 128), (512, 16, 64), (512, 32, 64)])
def test_vq_kernel_matches_plain(card, n, k, d):
    from ctvae_torch.ops import vq
    rng = np.random.default_rng(n)
    x, cb = _t(rng, n, d), _t(rng, k, d)
    cb[k - 1] = cb[1]            # a duplicated code: the first index wins
    x[0] = cb[1]
    before = vq.launches
    got = vq.l2_argmin(x, cb)
    torch.cuda.synchronize()
    assert vq.launches == before + 1
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  vq.l2_argmin_plain(x, cb).cpu().numpy())
    assert int(got[0]) == 1


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("B,S,T,H,ns,shift", [
    (3, 7, 7, 24, 0.01, 0.0), (3, 9, 13, 800, 0.01, 0.0),
    (3, 64, 64, 33, 0.01, 0.0),
    # S != T, T below a 64-target tile; several tiles of a sample
    (3, 65, 13, 800, 0.01, 0.0), (2, 130, 70, 100, 0.01, 0.0),
    # Hd not a multiple of 4 (no cp.async) nor of the 32-unit chunk
    (3, 20, 20, 801, 0.01, 0.0),
    # the leaky split at its ends: |p| alone, and linear alone
    (3, 16, 16, 100, 0.0, 0.0), (3, 16, 16, 100, 1.0, 0.0),
    # |xl|, |xr| ~ 8 >> |pre|: the separable linear sums cancel
    (3, 64, 64, 800, 0.01, 8.0),
    # the headline batches: B = 16 (clusters of 16 blocks) and A*B = 192
    (16, 64, 64, 800, 0.01, 0.0), (192, 64, 64, 800, 0.01, 0.0),
    # S = 2 * 8 * 8 of codebooks: 2 at 64 x 64
    (3, 128, 128, 800, 0.01, 0.0), (16, 128, 128, 800, 0.01, 0.0)])
def test_pairwise_kernel_matches_plain(card, per_sample, B, S, T, H, ns,
                                       shift):
    """The forward kernel against the plain version, shared and
    per-sample params, w2 of both signs, ragged S, T and Hd, slopes 0,
    0.01 and 1; two launches agree bit for bit."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    rng = np.random.default_rng(S * T + H + B)
    pshape = (B, H) if per_sample else (H,)
    args = (_t(rng, B, S, H, scale=0.5) + shift,
            _t(rng, B, T, H, scale=0.5) - shift,
            _t(rng, *pshape, scale=H ** -0.5), _t(rng, *pshape, scale=0.1),
            _t(rng, *pshape[:-1], scale=0.1))
    assert (args[2] > 0).any() and (args[2] < 0).any()
    before = pf.launches
    got = pf.flash_pairwise(*args, ns)
    torch.cuda.synchronize()
    assert pf.launches == before + 1
    want = fused_pairwise_scores(*args, ns)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=0)
    assert torch.equal(pf.flash_pairwise(*args, ns), got)


def test_pairwise_fwd_occupancy(card):
    """At the headline shapes the forward kernel fits two blocks of 8
    warps per SM without spilling, and at B = 16 its clusters split the
    hidden units over enough blocks to reach every SM."""
    from ctvae_torch.ops import pairwise_flash as pf
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    occ = pf.fwd_occupancy(16, 64, 64, 800)
    assert occ["warps"] == 8 and occ["local_bytes"] == 0, occ
    assert occ["blocks_per_sm"] >= 2, occ
    assert 16 * occ["cluster"] >= nsm, occ
    assert 192 * pf.fwd_occupancy(192, 64, 64, 800)["cluster"] >= nsm


def test_pairwise_fwd_rejects_too_large_grid(card):
    """More samples than the forward's grid takes: the wrapper says so
    before launching."""
    from ctvae_torch.ops import pairwise_flash as pf
    B = pf.GRID_LIMIT + 1
    x = torch.zeros(B, 1, 1, device="cuda")
    w = torch.zeros(1, device="cuda")
    before = pf.launches
    with pytest.raises(ValueError, match="grid"):
        pf.flash_pairwise_cuda(x, x, w, w, torch.zeros((), device="cuda"),
                               0.01)
    assert pf.launches == before


@pytest.mark.parametrize("S,T,H,F,density", [
    (9, 9, 3, 5, 0.5), (65, 65, 13, 100, 0.5), (33, 33, 2, 128, 0.5),
    (7, 11, 2, 40, 0.6), (33, 20, 2, 128, 0.6),
    # a dense mask; live-source counts that are not multiples of 8
    (65, 65, 13, 100, 1.0), (20, 33, 2, 64, 1.0), (13, 13, 3, 40, 0.5),
    (65, 65, 2, 100, 0.5),
    # T = 16: 16 warps, one target each
    (16, 16, 2, 40, 0.6),
    # S + 1 = 129 graph nodes of codebooks: 2 at 64 x 64 (one block per SM)
    (129, 129, 13, 100, 0.5), (129, 129, 13, 100, 1.0),
    # noise: endo adds a second support node: 66 and 130 nodes
    (66, 66, 13, 100, 0.5), (130, 130, 13, 100, 0.5),
    # TCeleba's 20 actions: 21 heads
    (65, 65, 21, 100, 0.5), (65, 65, 21, 100, 1.0)])
def test_gat_kernel_matches_plain(card, S, T, H, F, density):
    """The forward kernel against the plain version: out, and the alpha
    residual against the plain masked softmax (ragged S != T, F below and
    above one warp, sparse and dense masks, an edgeless target and a
    target with one live source); two runs agree bit for bit."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.gat import gat_logits, masked_incoming_softmax
    rng = np.random.default_rng(S + 2 * T + F + int(10 * density))
    args = (*_gat_args(rng, 4, S, T, H, F, density), 0.2)
    before = gf.launches
    got = gf.flash_gat(*args)
    torch.cuda.synchronize()
    assert gf.launches == before + 1
    want = gf.flash_gat_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)
    assert not got[:, 2].any()
    out, alpha = gf.flash_gat_cuda(*args, keep_alpha=True)
    xl, xr, adj, mask, we, att, ns = args
    want_alpha = masked_incoming_softmax(
        gat_logits(xl, xr, adj, we, att, ns), mask).permute(0, 3, 2, 1)
    np.testing.assert_allclose(alpha.cpu().numpy(), want_alpha.cpu().numpy(),
                               atol=1e-6, rtol=1e-5)
    again, alpha2 = gf.flash_gat_cuda(*args, keep_alpha=True)
    assert torch.equal(out, got) and torch.equal(again, got)
    assert torch.equal(alpha2, alpha)


def test_gat_fwd_occupancy(card):
    """At the headline shapes the forward kernel fits two blocks of 13
    warps per SM without spilling (it needs no launch bounds for that)."""
    from ctvae_torch.ops import gat_flash as gf
    occ = gf.fwd_occupancy(65, 65, 100)
    assert occ["warps"] == 13 and occ["local_bytes"] == 0, occ
    assert occ["blocks_per_sm"] >= 2, occ


def _close_grads(names, got, want, rel=1e-5):
    """Every gradient within ``rel`` of its scale, max(1, max |want|): the
    kernels and autograd sum up to a few thousand f32 terms in other
    orders (measured errors are ~1e-7 of the scale)."""
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= rel * scale, (name, err, scale)


def _pairwise_dout(rng, B, S, T, kind):
    """The upstream gradient of a pairwise backward case: dense; "zero"
    everywhere; whole zero source rows at ~25% pair density (as the
    intervention discoverer's masked rows give it) and a sample with no
    live row; "-0.0" entries (a masked negative product) and a zero
    column; or zero 8-target segments inside live rows."""
    dout = _t(rng, B, S, T)
    if kind == "zero":
        dout.zero_()
    elif kind == "rows":
        dout *= torch.from_numpy(rng.uniform(size=(B, S, 1)) < 0.25).cuda()
        dout[0] = 0.0
    elif kind == "negzero":
        dout[:, ::2] = -0.0
        dout[:, :, 3] = 0.0
    elif kind == "segments":
        dout[:, :, :8] = 0.0
        dout[:, 1::3, 8:16] = 0.0
        dout[:, 1] = 0.0
    return dout


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("S,T,H,ns,kind,shift", [
    (7, 7, 24, 0.01, "dense", 0.0), (9, 13, 800, 0.01, "dense", 0.0),
    (64, 64, 33, 0.01, "dense", 0.0),
    # upstream gradients the kernel skips in part or in whole
    (64, 64, 800, 0.01, "rows", 0.0), (13, 21, 100, 0.0, "rows", 0.0),
    (8, 8, 100, 1.0, "zero", 0.0), (12, 20, 33, 0.01, "negzero", 0.0),
    (10, 29, 800, 0.01, "segments", 0.0),
    # more than 64 targets (T rounded up to 8 is wider than a block's 64
    # hidden units) and the largest S = T that fits a block with dout
    # staged; past it dout is read from device memory: S = 2 * 8 * 8 of
    # codebooks: 2 at 64 x 64, and the largest S = T that fits then
    (72, 72, 800, 0.01, "dense", 0.0), (120, 120, 100, 0.01, "rows", 0.0),
    (121, 121, 100, 0.01, "rows", 0.0), (128, 128, 800, 0.01, "dense", 0.0),
    (128, 128, 100, 0.01, "segments", 0.0),
    (152, 152, 100, 0.01, "dense", 0.0),
    # |xl|, |xr| ~ 8 >> |pre|: dw2 from the separable sums cancels
    (64, 64, 100, 0.01, "dense", 8.0)])
def test_pairwise_bwd_kernel_matches_plain(card, per_sample, S, T, H, ns,
                                           kind, shift):
    """FlashPairwise's backward kernel against the plain version's
    autograd, shared (summed over the batch) and per-sample params, with
    dense and partly or wholly zero upstream gradients, T not a multiple
    of 8 and slopes 0, 0.01 and 1; two runs agree bit for bit."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    rng = np.random.default_rng(S * T + H + 1)
    B = 3
    pshape = (B, H) if per_sample else (H,)
    args = [_t(rng, B, S, H, scale=0.5) + shift,
            _t(rng, B, T, H, scale=0.5) - shift,
            _t(rng, *pshape, scale=H ** -0.5), _t(rng, *pshape, scale=0.1),
            _t(rng, *pshape[:-1], scale=0.1)]
    dout = _pairwise_dout(rng, B, S, T, kind)
    leaves = [a.clone().requires_grad_() for a in args]
    before = pf.bwd_launches
    got = torch.autograd.grad(pf.flash_pairwise(*leaves, ns), leaves, dout)
    torch.cuda.synchronize()
    assert pf.bwd_launches == before + 1
    want = torch.autograd.grad(fused_pairwise_scores(*leaves, ns), leaves,
                               dout)
    _close_grads(("dxl", "dxr", "dw2", "db1", "db2"), got, want)
    again = torch.autograd.grad(pf.flash_pairwise(*leaves, ns), leaves,
                                dout)
    for g, h in zip(got, again):      # no atomics: bit for bit
        assert torch.equal(g, h)
    if kind in ("rows", "zero"):      # a sample without a live row
        assert not got[0][0].any() and not got[1][0].any()


@pytest.mark.parametrize("S,T,H,B", [(16, 16, 200, 1100), (16, 16, 800, 430)])
def test_pairwise_bwd_several_chunks_per_block(card, S, T, H, B):
    """A batch large enough that a block of the backward walks several
    64-unit hidden chunks of its sample (here 2 of 4, ragged, and 3 of
    13, unevenly dealt) against the plain version's autograd, with dead
    rows and a dead sample; two runs agree bit for bit."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = pf.bwd_occupancy(S, T)["blocks_per_sm"]
    nch = -(-H // 64)
    blocks = min(max(-(-8 * nsm * per_sm // B), 1), nch)
    assert -(-nch // blocks) >= 2, (nsm, per_sm, blocks)
    rng = np.random.default_rng(B)
    args = [_t(rng, B, S, H, scale=0.5), _t(rng, B, T, H, scale=0.5),
            _t(rng, B, H, scale=H ** -0.5), _t(rng, B, H, scale=0.1),
            _t(rng, B, scale=0.1)]
    dout = _pairwise_dout(rng, B, S, T, "rows")
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(pf.flash_pairwise(*leaves, 0.01), leaves, dout)
    want = torch.autograd.grad(fused_pairwise_scores(*leaves, 0.01), leaves,
                               dout)
    _close_grads(("dxl", "dxr", "dw2", "db1", "db2"), got, want)
    again = torch.autograd.grad(pf.flash_pairwise(*leaves, 0.01), leaves,
                                dout)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def test_pairwise_bwd_occupancy(card):
    """At the headline shapes (S = T = 64) the backward kernel fits two
    blocks of 8 warps per SM without spilling (one left it at half the
    speed: 96.8 KB of shared memory and up to 128 registers a thread); at
    S = T = 128 (dout read from device memory) one block without
    spilling."""
    from ctvae_torch.ops import pairwise_flash as pf
    occ = pf.bwd_occupancy(64, 64)
    assert occ["warps"] == 8 and occ["local_bytes"] == 0, occ
    assert occ["regs"] <= 128 and occ["blocks_per_sm"] >= 2, occ
    occ = pf.bwd_occupancy(128, 128)
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


def test_pairwise_bwd_rejects_too_large_tile(card):
    """Past S = T = 152 the backward's tiles do not fit a block's shared
    memory even with dout read from device memory: the wrapper says so
    before launching."""
    from ctvae_torch.ops import pairwise_flash as pf
    B, S, H = 1, 153, 32
    xl = torch.zeros(B, S, H, device="cuda")
    out = torch.zeros(B, S, S, device="cuda")
    w2 = torch.zeros(H, device="cuda")
    before = pf.bwd_launches
    with pytest.raises(ValueError, match="shared memory"):
        pf.flash_pairwise_bwd_cuda(xl, xl, w2, w2, out, out, 0.01)
    assert pf.bwd_launches == before


def _gat_args(rng, B, S, T, H, F, density=0.6):
    """GAT inputs with a mask of the given edge density, a target with no
    incoming edge (t = 2) and one with exactly one (t = 0, from s = 1)."""
    xl, xr = _t(rng, B, S, H, F), _t(rng, B, T, H, F)
    we, att = _t(rng, H, F, scale=0.3), _t(rng, H, F, scale=0.3)
    mask = torch.from_numpy(rng.uniform(size=(B, S, T)) < density).cuda()
    mask[:, :, 2] = False        # a target with no incoming edge
    mask[:, :, 0] = False
    mask[:, 1, 0] = True         # a target with one incoming edge
    adj = torch.from_numpy(rng.uniform(size=(B, S, T)).astype(
        np.float32)).cuda() * mask
    return xl, xr, adj, mask, we, att


@pytest.mark.parametrize("S,T,H,F,density", [
    (9, 9, 3, 5, 0.6), (7, 11, 2, 40, 0.6), (65, 65, 13, 100, 0.6),
    (33, 20, 2, 128, 0.6),
    # a dense mask; live-source counts that are not multiples of 8
    (65, 65, 13, 100, 1.0), (20, 33, 2, 64, 1.0), (13, 13, 3, 40, 0.5),
    (65, 65, 2, 100, 0.5),
    # T = 16: the backward caps its block at 13 warps (launch bounds)
    (16, 16, 2, 40, 0.6),
    # the scratch rows over the dout tile: S + 1 = 129 graph nodes of
    # codebooks: 2 at 64 x 64, and the largest S = T that fits then
    (129, 129, 13, 100, 0.5), (129, 129, 13, 100, 1.0),
    (133, 133, 2, 100, 0.6),
    # noise: endo's second support node: 66 and 130 nodes
    (66, 66, 13, 100, 0.5), (130, 130, 13, 100, 0.5),
    # TCeleba's 20 actions: 21 heads
    (65, 65, 21, 100, 0.6), (65, 65, 21, 100, 1.0)])
def test_gat_bwd_kernel_matches_plain(card, S, T, H, F, density):
    """FlashGAT: the alpha residual against the plain softmax, and the
    backward kernel against the plain version's autograd (ragged S != T,
    F below and above one warp, sparse and dense masks, an edgeless target
    and a target with one live source); two runs agree bit for bit."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.gat import gat_logits, masked_incoming_softmax
    rng = np.random.default_rng(S + T + F + int(10 * density))
    B = 3
    xl, xr, adj, mask, we, att = _gat_args(rng, B, S, T, H, F, density)
    dout = _t(rng, B, T, H, F)
    _, alpha = gf.flash_gat_cuda(xl, xr, adj, mask, we, att, 0.2,
                                 keep_alpha=True)
    want_alpha = masked_incoming_softmax(
        gat_logits(xl, xr, adj, we, att, 0.2), mask).permute(0, 3, 2, 1)
    np.testing.assert_allclose(alpha.cpu().numpy(), want_alpha.cpu().numpy(),
                               atol=1e-6, rtol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (xl, xr, adj, we, att)]

    def run(fn):
        out = fn(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4],
                 0.2)
        return torch.autograd.grad(out, leaves, dout)

    before = gf.bwd_launches
    got = run(gf.flash_gat)
    torch.cuda.synchronize()
    assert gf.bwd_launches == before + 1
    want = run(gf.flash_gat_plain)
    _close_grads(("dxl", "dxr", "dadj", "dwe", "datt"), got, want)
    assert not got[1][:, 2].any()     # the edgeless target: no gradient
    for g, h in zip(got, run(gf.flash_gat)):
        assert torch.equal(g, h)


def test_gat_bwd_two_blocks_per_sm(card):
    """At the headline shapes the backward kernel fits two blocks per SM
    without spilling: its launch bounds cap it at 72 registers. At S = T =
    129 (the scratch rows over the dout tile) one block, no spills."""
    from ctvae_torch.ops import gat_flash as gf
    occ = gf.bwd_occupancy(65, 65, 100)
    assert occ["warps"] == 13 and occ["regs"] <= 72, occ
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 2, occ
    occ = gf.bwd_occupancy(129, 129, 100)
    assert occ["warps"] == 13 and occ["local_bytes"] == 0, occ
    assert occ["blocks_per_sm"] >= 1, occ


def test_gat_bwd_rejects_too_large_tile(card):
    """Past S = T = 133 at F = 100 the backward's tiles do not fit a
    block's shared memory even with the scratch rows over the dout tile:
    the wrapper says so before launching."""
    from ctvae_torch.ops import gat_flash as gf
    B, S, H, F = 1, 134, 1, 100
    x = torch.zeros(B, S, H, F, device="cuda")
    adj = torch.zeros(B, S, S, device="cuda")
    w = torch.zeros(H, F, device="cuda")
    alpha = torch.zeros(B, H, S, S, device="cuda")
    before = gf.bwd_launches
    with pytest.raises(ValueError, match="shared memory"):
        gf.flash_gat_bwd_cuda(x, x, adj, adj.bool(), w, w, alpha, x, 0.2)
    assert gf.bwd_launches == before


def test_gat_serving_call_keeps_no_alpha(card):
    """Without autograd the wrapper launches the forward alone
    (``ctvae::gat_fwd``: no alpha written, no autograd node); with it,
    ``ctvae::gat_fwd_alpha``, whose node is the op's registered
    gradient."""
    from ctvae_torch.ops import gat_flash as gf
    args = _gat_args(np.random.default_rng(0), 2, 9, 9, 3, 5)
    with torch.no_grad():
        out = gf.flash_gat(*args, 0.2)
    assert out.grad_fn is None
    leaves = [a.clone().requires_grad_() if a.dtype == torch.float32 else a
              for a in args]
    assert "ctvae_gat_fwd_alpha" in \
        type(gf.flash_gat(*leaves, 0.2).grad_fn).__name__


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops import vq
    x = torch.zeros(4, 8, device="cuda")
    with pytest.raises(ValueError):
        vq.l2_argmin_cuda(x.cpu(), x.cpu())
    with pytest.raises(TypeError):
        vq.l2_argmin_cuda(x.double(), x.double())
    with pytest.raises(ValueError):
        vq.l2_argmin_cuda(torch.zeros(8, 4, device="cuda").T, x)
    xl = torch.zeros(2, 3, 5, device="cuda")
    with pytest.raises(ValueError):
        pf.flash_pairwise_cuda(xl, xl, torch.zeros(4, device="cuda"),
                               torch.zeros(5, device="cuda"),
                               torch.zeros((), device="cuda"), 0.01)
    g = torch.zeros(1, 3, 1, 200, device="cuda")
    adj = torch.zeros(1, 3, 3, device="cuda")
    with pytest.raises(ValueError):   # more features than a warp holds
        gf.flash_gat_cuda(g, g, adj, adj.bool(),
                          torch.zeros(1, 200, device="cuda"),
                          torch.zeros(1, 200, device="cuda"), 0.2)


def _draws(seed, device):
    from ctvae_torch.models.base import Draws

    class CpuSeeded(Draws):
        def uniform(self, shape):
            return torch.rand(tuple(shape), generator=self.generator
                              ).to(self.device)

    return CpuSeeded(torch.Generator().manual_seed(seed), torch.device(device))


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_small_model_on_card_matches_cpu(card, mode):
    """A small CT-MCQ-VAE on the card (kernels) against the same weights
    on the CPU (plain versions), with the same draws."""
    import copy

    from ctvae_torch.models import build_model
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    model = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(1)
    x, y = torch.rand(3, 16, 16, 3, generator=g), torch.rand(3, 16, 16, 3,
                                                             generator=g)
    a = torch.eye(8)[torch.randint(0, 8, (3,), generator=g)]
    with torch.inference_mode():
        got = model(x.cuda(), input_y=y.cuda(), action=a.cuda(), mode=mode,
                    draws=_draws(2, "cuda"))
        want = cpu_model(x, input_y=y, action=a, mode=mode,
                         draws=_draws(2, "cpu"))
    np.testing.assert_allclose(got["recons"].cpu().numpy(),
                               want["recons"].numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(got["ct_loss"]), float(want["ct_loss"]),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("img", [16, 32])
@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_small_model_gradients_on_card_match_cpu(card, mode, img):
    """One train forward + backward of a small CT-MCQ-VAE on the card
    (both backward kernels) against the same weights and draws on the CPU
    (plain autograd): the loss and every parameter's gradient. At img 32
    the two codebooks give S = 2 * 8 * 8 = 128 sites (129 graph nodes),
    past what the backward kernels took with dout in shared memory."""
    import copy

    from ctvae_torch.models import build_model
    from ctvae_torch.ops import gat_flash, pairwise_flash
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=img, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    model = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(3)
    x, y = (torch.rand(3, img, img, 3, generator=g),
            torch.rand(3, img, img, 3, generator=g))
    a = torch.eye(8)[torch.randint(0, 8, (3,), generator=g)]
    before = (pairwise_flash.bwd_launches, gat_flash.bwd_launches)
    losses = []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        out = m(x.to(dev), input_y=y.to(dev), action=a.to(dev), mode=mode,
                draws=_draws(4, dev), train=True)
        loss = m.loss_function(out)["loss"]
        loss.backward()
        losses.append(float(loss))
    assert pairwise_flash.bwd_launches == before[0] + 2
    assert gat_flash.bwd_launches == before[1] + 1
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        q = cpu_params[name]
        if q.grad is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        scale = max(1.0, float(q.grad.abs().max()))
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, \
            name


def _logits_args(rng, B, S, T, K, F, per_sample):
    """Per-head logits inputs with exact zeros of pre: xr[b, 2] = -xl[b, 1]
    and adj[b, 1, 2] = 0, so pre[b, 1, 2] = 0 for every head and
    feature."""
    xl, xr = _t(rng, B, S, K, F), _t(rng, B, T, K, F)
    xr[:, 2] = -xl[:, 1]
    pshape = (B, K, F) if per_sample else (K, F)
    we, att = _t(rng, *pshape, scale=0.3), _t(rng, *pshape, scale=0.3)
    adj = torch.from_numpy(rng.uniform(size=(B, S, T)).astype(
        np.float32)).cuda()
    adj[:, 1, 2] = 0.0
    return xl, xr, adj, we, att


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("B,S,T,K,F,ns,shift,d_kind", [
    (3, 9, 9, 2, 5, 0.2, 0.0, "rand"), (3, 7, 11, 3, 40, 0.2, 0.0, "rand"),
    (3, 65, 65, 2, 64, 0.2, 0.0, "rand"),
    (3, 65, 65, 13, 100, 0.2, 0.0, "rand"),
    (3, 33, 20, 1, 128, 0.2, 0.0, "rand"),
    # the headline batches: B = 16 with one and two heads (the forward's
    # strips and the backward's chunks spread over every SM), A*B = 192
    (16, 65, 65, 1, 64, 0.2, 0.0, "rand"),
    (16, 65, 65, 2, 64, 0.2, 0.0, "rand"),
    (192, 65, 65, 2, 64, 0.2, 0.0, "rand"),
    # the leaky map at its ends: |p| alone and linear alone
    (3, 13, 17, 2, 33, 0.0, 0.0, "rand"), (3, 13, 17, 2, 33, 1.0, 0.0, "rand"),
    # |xl|, |xr| ~ 8 >> |pre|: the separable sums cancel
    (3, 65, 65, 2, 64, 0.2, 8.0, "rand"),
    # no pair with a gradient, and one: the pair where pre is exactly 0
    (3, 65, 65, 2, 64, 0.2, 0.0, "zero"), (3, 65, 65, 2, 64, 0.2, 0.0, "one"),
    # the 129 graph nodes of codebooks: 2 at 64 x 64
    (16, 129, 129, 2, 64, 0.2, 0.0, "rand"),
    (3, 129, 129, 13, 100, 0.2, 0.0, "rand"),
    # the search's codebooks of 16 and 32 codes (F = N), B = 8 and the
    # causal A*B = 96, at 65 / 66 / 129 / 130 nodes
    (8, 66, 66, 1, 16, 0.2, 0.0, "rand"), (96, 65, 65, 2, 16, 0.2, 0.0, "rand"),
    (96, 66, 66, 2, 32, 0.2, 0.0, "rand"),
    (8, 129, 129, 2, 32, 0.2, 0.0, "rand"),
    (96, 130, 130, 2, 16, 0.2, 0.0, "rand"),
    (96, 130, 130, 2, 32, 0.2, 0.0, "rand")])
def test_gat_logits_kernels_match_plain(card, per_sample, B, S, T, K, F, ns,
                                        shift, d_kind):
    """The per-head logits forward against ``gat_logits``, and its backward
    against the plain version's autograd (shared heads summed over the
    batch, per-sample heads their own rows), with exact zeros of pre and
    zero upstream gradients (the softmax's non-edges); two runs of each
    agree bit for bit."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    rng = np.random.default_rng(S * T + K * F + per_sample + B)
    xl, xr, adj, we, att = _logits_args(rng, B, S, T, K, F, per_sample)
    args = (xl + shift, xr - shift, adj, we, att)   # keeps pre[b, 1, 2] = 0
    before = gl.launches
    got = gl.fused_gat_logits(*args, ns)
    torch.cuda.synchronize()
    assert gl.launches == before + 1 and got.grad_fn is None
    want = gat_logits(*args, ns)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(gl.fused_gat_logits(*args, ns), got)
    d_e = _t(rng, B, S, T, K)
    d_e[:, :, 3] = 0.0
    if d_kind == "zero":
        d_e.zero_()
    elif d_kind == "one":               # (b, s, t, k) = (0, 1, 2, 0) alone
        d_e[:] = torch.where(torch.arange(d_e.numel(), device="cuda").view(
            d_e.shape) == (T + 2) * K, d_e, 0.0)
        assert int((d_e != 0).sum()) == 1 and float(d_e[0, 1, 2, 0]) != 0
    leaves = [a.clone().requires_grad_() for a in args]
    before = gl.bwd_launches
    out = gl.fused_gat_logits(*leaves, ns)
    assert "ctvae_gat_logits_fwd" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, d_e)
    torch.cuda.synchronize()
    assert gl.bwd_launches == before + 1
    want = torch.autograd.grad(gat_logits(*leaves, ns), leaves, d_e)
    _close_grads(("dxl", "dxr", "dadj", "dwe", "datt"), grads, want)
    again = torch.autograd.grad(gl.fused_gat_logits(*leaves, ns), leaves,
                                d_e)
    for g, h in zip(grads, again):      # no atomics: bit for bit
        assert torch.equal(g, h)


def test_gat_logits_occupancy(card):
    """At the headline shapes both kernels run without spilling more than a
    few bytes, the backward at 4 blocks of 8 warps per SM (launch bounds
    of 64 registers), and at B = 16 with one head both grids give every SM
    a block."""
    from ctvae_torch.ops import gat_logits as gl
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, K in ((16, 1), (16, 2), (192, 2)):
        fwd = gl.fwd_occupancy(B, 65, 65, K, 64)
        bwd = gl.bwd_occupancy(B, 65, 65, 64)
        assert fwd["local_bytes"] == 0 and fwd["blocks_per_sm"] >= 2, fwd
        assert bwd["regs"] <= 64 and bwd["local_bytes"] <= 32, bwd
        assert bwd["blocks_per_sm"] == 4, bwd
        assert B * K * fwd["strips"] >= nsm and B * bwd["parts"] >= nsm


def test_gat_logits_rejects_too_large_grid(card):
    """More samples (forward: samples x heads) than the grids' y dimension
    takes: the wrappers say so before launching."""
    from ctvae_torch.ops import gat_logits as gl
    B = gl.GRID_LIMIT + 1
    x = torch.zeros(B, 1, 1, 1, device="cuda")
    adj = torch.zeros(B, 1, 1, device="cuda")
    w = torch.zeros(1, 1, device="cuda")
    before = (gl.launches, gl.bwd_launches)
    with pytest.raises(ValueError, match="grid"):
        gl.fused_gat_logits_cuda(x, x, adj, w, w, 0.2)
    with pytest.raises(ValueError, match="grid"):
        gl.fused_gat_logits_bwd_cuda(x, x, adj, w, w, x, 0.2)
    assert (gl.launches, gl.bwd_launches) == before


def test_gat_logits_wrapper_rejects_what_the_kernels_do_not_take(card):
    from ctvae_torch.ops import gat_logits as gl
    args = _logits_args(np.random.default_rng(0), 2, 5, 5, 2, 8, True)
    xl, xr, adj, we, att = args
    with pytest.raises(ValueError):          # a CPU tensor
        gl.fused_gat_logits_cuda(xl.cpu(), xr, adj, we, att, 0.2)
    with pytest.raises(TypeError):
        gl.fused_gat_logits_cuda(xl.double(), xr, adj, we, att, 0.2)
    with pytest.raises(ValueError):          # not contiguous
        gl.fused_gat_logits_cuda(xl.transpose(1, 2).contiguous().transpose(
            1, 2), xr, adj, we, att, 0.2)
    with pytest.raises(ValueError):          # heads of another batch
        gl.fused_gat_logits_cuda(xl, xr, adj, we[:1], att[:1], 0.2)
    with pytest.raises(ValueError):          # more features than 4 per lane
        g = torch.zeros(1, 3, 1, 200, device="cuda")
        w = torch.zeros(1, 200, device="cuda")
        gl.fused_gat_logits_cuda(g, g, adj[:1, :3, :3].contiguous(), w, w,
                                 0.2)
    with pytest.raises(ValueError):          # d_e of another shape
        gl.fused_gat_logits_bwd_cuda(xl, xr, adj, we, att,
                                     torch.zeros(2, 5, 5, 1, device="cuda"),
                                     0.2)


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_multi_train_step_graph_equals_eager_steps(card, mode):
    """A small CT-MCQ-VAE trained 8 steps eagerly and through two calls
    of ``make_multi_train_step(mode, 4)`` (warm-up steps, a CUDA graph
    captured and replayed) from equal states on the same batches, with a
    gradient clip and an LR that falls every 3 updates: every
    parameter and Adam moment within 1e-6 of its largest magnitude, the
    generator states, steps and optimizer counts equal; the replays make
    every kernel launch of an eager step without ticking the counters."""
    from ctvae_torch.models import build_model
    from ctvae_torch.ops import launch_counts
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_multi_train_step, make_train_step)
    from ctvae_torch.training.state import WARMUP_STEPS
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    exp = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0,
               gradient_clip_val=0.5)
    states = []
    for _ in range(2):
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        states.append(create_train_state(m, build_optimizers(exp, m, 3),
                                         seed=5))
    g = torch.Generator().manual_seed(6)
    stacked = {"image": torch.rand(8, 3, 16, 16, 3, generator=g),
               "input_y": torch.rand(8, 3, 16, 16, 3, generator=g),
               "action": torch.eye(8)[torch.randint(0, 8, (8, 3),
                                                    generator=g)]}
    stacked = {k: v.cuda() for k, v in stacked.items()}
    step = make_train_step(mode)
    before = launch_counts()
    step(states[0], {k: v[0] for k, v in stacked.items()})
    per_step = {k: n - before[k] for k, n in launch_counts().items()}
    for i in range(1, 8):
        step(states[0], {k: v[i] for k, v in stacked.items()})
    multi = make_multi_train_step(mode, 4)
    for half in (slice(0, 4), slice(4, 8)):
        multi(states[1], {k: v[half] for k, v in stacked.items()})
    assert multi.replays == 8 - WARMUP_STEPS
    assert multi.replayed_launches() == {k: n * multi.replays
                                         for k, n in per_step.items()}
    eager, graph = states
    for a, b in zip(eager.model.parameters(), graph.model.parameters()):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
    for oa, ob in zip(eager.optimizers, graph.optimizers):
        assert oa.count == ob.count == 8
        for pa, pb in zip(oa.params, ob.params):
            for k, va in oa.adam.state.get(pa, {}).items():
                vb = ob.adam.state[pb][k]
                assert float((va - vb).abs().max()) <= \
                    1e-6 * float(va.abs().max()), k
    assert eager.step == graph.step == 8
    assert torch.equal(eager.generator.get_state(),
                       graph.generator.get_state())
    # its graphs hold the state they were captured from
    with pytest.raises(ValueError, match="another train state"):
        multi(eager, {k: v[:4] for k, v in stacked.items()})


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_multi_train_step_graph_with_ema_equals_eager_steps(card, mode):
    """A small CT-MCQ-VAE with the EMA codebook (revival at threshold 0.5
    drawing from the train generator), the rotation estimator and the
    endo noise node, trained 8 steps eagerly and through two calls of
    ``make_multi_train_step(mode, 4)`` from equal states: every parameter,
    Adam moment and EMA buffer within 1e-6 of its largest magnitude, the
    buffers moved, the generators and steps equal."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_multi_train_step, make_train_step)
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="endo", ema=True, revive_threshold=0.5,
               grad_estimator="rotation")
    exp = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0)
    states = []
    for _ in range(2):
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        states.append(create_train_state(m, build_optimizers(exp, m, 3),
                                         seed=5))
    init = {n: b.clone() for n, b in states[0].model.named_buffers()}
    g = torch.Generator().manual_seed(6)
    stacked = {"image": torch.rand(8, 3, 16, 16, 3, generator=g),
               "input_y": torch.rand(8, 3, 16, 16, 3, generator=g),
               "action": torch.eye(8)[torch.randint(0, 8, (8, 3),
                                                    generator=g)]}
    stacked = {k: v.cuda() for k, v in stacked.items()}
    step = make_train_step(mode)
    for i in range(8):
        step(states[0], {k: v[i] for k, v in stacked.items()})
    multi = make_multi_train_step(mode, 4)
    for half in (slice(0, 4), slice(4, 8)):
        multi(states[1], {k: v[half] for k, v in stacked.items()})
    eager, graph = states
    a, b = eager.model.state_dict(), graph.model.state_dict()
    assert any(n.endswith("embed_avg") for n in a)
    for n, t in a.items():
        assert float((t - b[n]).abs().max()) <= 1e-6 * float(
            t.abs().max()), n
        if "quantizers_" in n:
            assert not torch.equal(t, init[n]), n
    for oa, ob in zip(eager.optimizers, graph.optimizers):
        for pa, pb in zip(oa.params, ob.params):
            for k, va in oa.adam.state.get(pa, {}).items():
                vb = ob.adam.state[pb][k]
                assert float((va - vb).abs().max()) <= \
                    1e-6 * float(va.abs().max()), k
    assert eager.step == graph.step == 8
    assert torch.equal(eager.generator.get_state(),
                       graph.generator.get_state())


def test_scan_steps_epoch_on_card_equals_per_step(card):
    """``VAEXperiment`` with ``scan_steps: 4`` on the card (a block of
    four causal batches through a captured graph, the rest step by step)
    ends a TSynthetic epoch in the state ``scan_steps: 1`` leaves: every
    parameter and Adam moment within 1e-6 of its largest magnitude, the
    generator states and steps equal."""
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    exps = []
    for k in (1, 4):
        data = VAEDataset("", dataset_name="TSynthetic", train_batch_size=4,
                          val_batch_size=4, patch_size=16, limit=40,
                          val_limit=8, seed=5)
        data.setup()
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        exp = VAEXperiment(m, dict(LR=5e-4, scan_steps=k), data)
        exp.setup(seed=3)
        exp.train_epoch(0)
        exps.append(exp)
    multi = exps[1]._multi_steps
    assert list(multi) == ["causal"] and multi["causal"].replays == 1
    a, b = exps[0].state, exps[1].state
    assert a.step == b.step == 30
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        p, q = p.detach(), q.detach()
        assert float((p - q).abs().max()) <= 1e-6 * float(p.abs().max())
    for oa, ob in zip(a.optimizers, b.optimizers):
        for pa, pb in zip(oa.params, ob.params):
            for k, va in oa.adam.state.get(pa, {}).items():
                vb = ob.adam.state[pb][k]
                assert float((va - vb).abs().max()) <= \
                    1e-6 * float(va.abs().max()), k


def test_train_state_resumes_on_card_from_host_form_adam(card):
    """A train state saved with Adam in its host form (a float LR and
    step counts on the host, as checkpoints of the card were written
    before Adam ran capturable there) resumes on the card in the
    capturable form, and the run goes on as one that was never saved,
    bit for bit."""
    import copy
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    exp = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0)
    states = []
    for _ in range(2):
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        states.append(create_train_state(m, build_optimizers(exp, m, 3),
                                         seed=5))
    g = torch.Generator().manual_seed(6)
    batches = [{"image": torch.rand(3, 16, 16, 3, generator=g).cuda(),
                "input_y": torch.rand(3, 16, 16, 3, generator=g).cuda(),
                "action": torch.eye(8)[torch.randint(0, 8, (3,),
                                                     generator=g)].cuda()}
               for _ in range(2)]
    step = make_train_step("action")
    step(states[0], batches[0])
    saved = copy.deepcopy(states[0].state_dict())
    adam = saved["optimizers"][0]["adam"]
    for group in adam["param_groups"]:
        group["capturable"], group["lr"] = False, float(group["lr"])
    for st in adam["state"].values():
        st["step"] = st["step"].cpu()
    states[1].load_state_dict(saved)
    loaded = states[1].optimizers[0].adam
    assert [g["capturable"] for g in loaded.param_groups] == [True]
    assert all(st["step"].is_cuda for st in loaded.state.values())
    for s in states:
        step(s, batches[1])
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    for pa, pb in zip(states[0].optimizers[0].params,
                      states[1].optimizers[0].params):
        for k, v in states[0].optimizers[0].adam.state[pa].items():
            assert torch.equal(v, loaded.state[pb][k]), k


def test_pinned_uint8_copy_equals_cpu_path(card):
    """``data/prefetch.py::to_device`` on the card (pinned memory, a
    non-blocking copy, the /255 on the device) gives the CPU path's
    float32 images bit for bit, and the same actions and labels; behind
    a queued kernel, so the copy really overlaps."""
    from ctvae_torch.data.prefetch import to_device
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8),
             "input_y": rng.integers(0, 256, (16, 64, 64, 3),
                                     dtype=np.uint8),
             "action": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 16)],
             "labels": rng.integers(0, 4, (16, 6))}
    want = to_device(batch, "cpu")
    busy = torch.randn(4096, 4096, device=card)
    for _ in range(4):
        busy = busy @ busy / 64.0          # work queued ahead of the copy
    got = to_device(batch, card)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype
        assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(want["image"],
                       torch.from_numpy(batch["image"].astype(np.float32)
                                        / 255.0))


# --- the disentanglement metrics' solvers on the card ------------------------

def _metric_data(K, n=320, D=48, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n)
    x = (rng.normal(size=(K, D))[y] + rng.normal(size=(n, D))
         ).astype(np.float32)
    x[:, 1] = 0.5                       # a constant column
    x[:, 2] = np.round(x[:, 2], 1)      # repeated values
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("K", [2, 5])
def test_gbt_on_card_matches_cpu(card, K):
    """``fit_gbt`` on the card against the same code on the CPU: every
    split's feature equal and its threshold within float32 rounding, raw
    predictions and importances within 1e-9 (the card's cumulative sums
    round in another order; tied splits break alike, by the same
    CPU-drawn feature order)."""
    from ctvae_torch.metrics.gbt import decision_function, fit_gbt
    x, y = _metric_data(K)
    cpu = fit_gbt(x, y, n_estimators=10)
    gpu = fit_gbt(x.cuda(), y.cuda(), n_estimators=10)
    assert gpu.feature.is_cuda
    assert torch.equal(gpu.feature.cpu(), cpu.feature)
    assert float((gpu.threshold.cpu() - cpu.threshold).abs().max()) <= 1e-6
    assert float((decision_function(gpu, x.cuda()).cpu()
                  - decision_function(cpu, x)).abs().max()) <= 1e-9
    assert float((gpu.importances.cpu() - cpu.importances).abs().max()
                 ) <= 1e-9


@pytest.mark.parametrize("K", [2, 5])
def test_linear_svc_on_card_matches_cpu(card, K):
    """``fit_linear_svc`` on the card against the CPU: coef and intercept
    within 1e-9 (both Newton solves converge), predictions equal."""
    from ctvae_torch.metrics.linear_svc import (fit_linear_svc,
                                                predict_linear_svc)
    x, y = _metric_data(K)
    cpu = fit_linear_svc(x, y)
    gpu = fit_linear_svc(x.cuda(), y.cuda())
    assert gpu.coef.is_cuda
    assert float((gpu.coef.cpu() - cpu.coef).abs().max()) <= 1e-9
    assert float((gpu.intercept.cpu() - cpu.intercept).abs().max()) <= 1e-9
    assert torch.equal(predict_linear_svc(gpu, x.cuda()).cpu(),
                       predict_linear_svc(cpu, x))


def test_watch_norms_in_graph_equal_eager(card):
    """``make_multi_train_step(mode, 4, watch_modules=True)``: the
    per-module gradient and parameter norms the captured graph returns
    equal those of eager steps from an equal state on the same batches
    (1e-6 relative; graph and eager steps agree bit for bit)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_multi_train_step, make_train_step)
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    exp = dict(LR=5e-4, weight_decay=0.0, gradient_clip_val=0.5)
    states = []
    for _ in range(2):
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        states.append(create_train_state(m, build_optimizers(exp, m, 3),
                                         seed=5))
    g = torch.Generator().manual_seed(6)
    stacked = {"image": torch.rand(8, 3, 16, 16, 3, generator=g),
               "input_y": torch.rand(8, 3, 16, 16, 3, generator=g),
               "action": torch.eye(8)[torch.randint(0, 8, (8, 3),
                                                    generator=g)]}
    stacked = {k: v.cuda() for k, v in stacked.items()}
    step = make_train_step("causal", watch_modules=True)
    for i in range(8):
        eager = step(states[0], {k: v[i] for k, v in stacked.items()})
    multi = make_multi_train_step("causal", 4, watch_modules=True)
    for half in (slice(0, 4), slice(4, 8)):
        graph = multi(states[1], {k: v[half] for k, v in stacked.items()})
    assert multi.replays > 0
    keys = [k for k in eager if k.startswith(("grad_norm/", "param_norm/"))]
    assert len(keys) == 8 and set(keys) <= set(graph)
    for k in keys:
        a, b = float(eager[k]), float(graph[k])
        assert abs(a - b) <= 1e-6 * max(abs(a), 1e-30), (k, a, b)


def test_vq_kernel_at_the_vq_vae_shape(card):
    """The VQ search at ``configs/vq_vae.yaml``'s shape (K = 512 codes of
    D = 64; B = 64 on the 16 x 16 latent grid: N = 16,384 rows, 8 passes
    of 64 codes): the kernel drops ||x||^2, so an index may differ from the
    plain version's only where the two distances are within 1e-5 of each
    other (a near-tie, counted in float64); a rerun is bit-identical."""
    from ctvae_torch.ops import vq
    rng = np.random.default_rng(512)
    x, cb = _t(rng, 16384, 64), _t(rng, 512, 64, scale=0.5)
    got = vq.l2_argmin(x, cb)
    assert torch.equal(vq.l2_argmin(x, cb), got)
    want = vq.l2_argmin_plain(x, cb)
    dist = (x.double() ** 2).sum(1, keepdim=True) \
        + (cb.double() ** 2).sum(1) - 2 * x.double() @ cb.double().T
    gap = (dist.gather(1, got[:, None]) - dist.gather(1, want[:, None])
           ).abs()[:, 0]
    differ = got != want
    near = gap <= 1e-5 * dist.gather(1, want[:, None])[:, 0].abs().clamp(
        min=1.0)
    assert int((differ & ~near).sum()) == 0
    assert int(differ.sum()) <= 16
    assert vq.occupancy(512, 64)["local_bytes"] == 0


class _CpuDraws:
    """Draws from a CPU generator on any device, so the card's step and
    the CPU's draw the same latents, noise and gamma variates."""

    def __init__(self, seed, device):
        self.generator = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator).to(
            self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator).to(
            self.device)

    def permutation(self, rows, n):
        return torch.argsort(torch.rand((rows, n), generator=self.generator),
                             dim=1, stable=True).to(self.device)

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator).to(self.device)

    def gamma(self, alpha):
        return torch._standard_gamma(alpha.detach().cpu(),
                                     generator=self.generator).to(
            self.device)

    def cauchy(self, shape):
        return torch.empty(tuple(shape)).cauchy_(
            generator=self.generator).to(self.device)


_SMALL = dict(in_channels=3, hidden_dims=[8, 16], img_size=16)
#: the zoo's members with their own architecture or draws, at small widths
ZOO_MORE = {
    "IWAE": dict(name="IWAE", latent_dim=8, num_samples=3, **_SMALL),
    "MIWAE": dict(name="MIWAE", latent_dim=8, num_samples=3,
                  num_estimates=2, **_SMALL),
    "SWAE": dict(name="SWAE", latent_dim=8, num_projections=6, **_SMALL),
    "SWAE-cauchy": dict(name="SWAE", latent_dim=8, num_projections=6,
                        projection_dist="cauchy", **_SMALL),
    "BetaTCVAE": dict(name="BetaTCVAE", in_channels=3, latent_dim=8,
                      hidden_dims=[8, 8], img_size=16, anneal_steps=10),
    "CategoricalVAE": dict(name="CategoricalVAE", latent_dim=4,
                           categorical_dim=5, anneal_rate=-0.1,
                           anneal_interval=2, **_SMALL),
    "JointVAE": dict(name="JointVAE", latent_dim=8, categorical_dim=5,
                     **_SMALL),
    "GammaVAE": dict(name="GammaVAE", latent_dim=8, **_SMALL),
    "VampVAE": dict(name="VampVAE", latent_dim=8, num_components=5,
                    **_SMALL),
    "HVAE": dict(name="HVAE", latent1_dim=8, latent2_dim=6, **_SMALL),
    "LVAE": dict(name="LVAE", in_channels=3, latent_dims=[4, 8],
                 hidden_dims=[8, 16], img_size=16),
}


@pytest.mark.parametrize("name", ["VanillaVAE", "VQVAE", "ConditionalVAE"]
                         + list(ZOO_MORE))
def test_zoo_train_step_on_card_matches_cpu(card, name, monkeypatch):
    """One train step (``M_N`` 0.5) of a small VanillaVAE / VQVAE /
    ConditionalVAE (with the batch's 0 / 1 labels of 40 attributes) and,
    at global step 5 (CategoricalVAE's temperature reads it), of each
    ZOO_MORE model on the card against the same
    weights and draws (normals, uniforms, cauchys and gamma variates of a
    CPU generator) on the CPU: the metrics, every gradient (1e-4 of its
    leaf's scale), every parameter after Adam (within what the gradients'
    difference allows) and the BatchNorm buffers (1e-5 / rtol 1e-4);
    VQVAE launched its VQ kernel once."""
    import copy

    from ctvae_torch.models import build_model
    from ctvae_torch.ops import vq
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    cfg = (dict(name=name, in_channels=3, embedding_dim=8, num_embeddings=32,
                hidden_dims=[8, 16], img_size=16) if name == "VQVAE" else
           ZOO_MORE[name] if name in ZOO_MORE else
           dict(name=name, in_channels=3, latent_dim=8, hidden_dims=[8, 16],
                img_size=16))
    model = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    cpu_model = copy.deepcopy(model).to("cpu")
    gen = torch.Generator().manual_seed(5)
    batch = {"image": torch.rand(4, 16, 16, 3, generator=gen)}
    if name == "ConditionalVAE":
        batch["labels"] = torch.randint(0, 2, (4, 40), generator=gen).float()
    exp = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
    metrics, grads = [], []
    kept = tstate._grads

    def grads_of(*args):
        out = kept(*args)
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in args[0].model.named_parameters()})
        return out

    monkeypatch.setattr(tstate, "_grads", grads_of)
    monkeypatch.setattr(tstate, "Draws",
                        lambda gen, device: _CpuDraws(7, device))
    before = vq.launches
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        state = tstate.create_train_state(m, topt.build_optimizers(exp, m,
                                                                   4))
        state.step = 5 if name in ZOO_MORE else 0
        metrics.append({k: float(v) for k, v in tstate.make_train_step(
            "base", M_N=0.5)(state, {k: v.to(dev) for k, v in
                                     batch.items()}).items()})
    torch.cuda.synchronize()
    assert vq.launches == before + (name == "VQVAE")
    assert metrics[0].keys() == metrics[1].keys()
    for k, v in metrics[1].items():
        np.testing.assert_allclose(metrics[0][k], v, rtol=1e-4, atol=1e-6)
    for n, g in grads[1].items():
        scale = max(1.0, float(g.abs().max()))
        assert float((grads[0][n] - g).abs().max()) <= 1e-4 * scale, n
    # Adam moves a parameter by lr g / (|g| + 1e-8): the gradients' own
    # difference bounds the parameters' (a conv bias before a BatchNorm
    # has a gradient of rounding noise alone)
    cpu_params = dict(cpu_model.named_parameters())
    for n, p in model.named_parameters():
        tol = 2e-6 + exp["LR"] / 1e-8 * (grads[0][n] - grads[1][n]).abs()
        assert bool(((p.detach().cpu() - cpu_params[n].detach()).abs()
                     <= tol).all()), n
    cpu_buffers = dict(cpu_model.named_buffers())
    for n, t in model.named_buffers():
        np.testing.assert_allclose(t.cpu().numpy(), cpu_buffers[n].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_standard_gamma_moments_on_card(card):
    """GammaVAE's draw on the card: ``Draws.gamma`` (``torch.
    _standard_gamma`` on a seeded CUDA generator) of 10^6 variates at
    alpha = 8.5 has mean and variance 8.5 within 1% (the estimates'
    standard errors: 0.03% and 0.16%), and a reseeded generator repeats
    them."""
    from ctvae_torch.models.base import Draws
    alpha = torch.full((10 ** 6,), 8.5, device=card)
    draw = [Draws(torch.Generator("cuda").manual_seed(11), card).gamma(alpha)
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and draw[0].device.type == "cuda"
    var, mean = torch.var_mean(draw[0].double())
    assert abs(float(mean) / 8.5 - 1.0) < 0.01, float(mean)
    assert abs(float(var) / 8.5 - 1.0) < 0.01, float(var)
    assert float(draw[0].min()) > 0.0


@pytest.mark.parametrize("loss_type", [None, "B", "labels", "categorical",
                                       "gamma"],
                         ids=["VanillaVAE", "BetaVAE-B", "ConditionalVAE",
                              "CategoricalVAE", "GammaVAE"])
def test_zoo_multi_train_step_graph_equals_eager_steps(card, loss_type):
    """A small VanillaVAE / BetaVAE B / ConditionalVAE trained 12 steps
    eagerly and through
    three calls of ``make_multi_train_step("base", 4, M_N=0.5)`` from equal
    states, under cuDNN's deterministic algorithms: each call's metrics
    against the eager step it ends on, every parameter, BatchNorm buffer
    and Adam moment within 1e-6 of its largest magnitude, the generators
    and steps equal. BetaVAE B's capacity C rises over the 12 steps
    (``Capacity_max_iter`` 12) to twice the first step's KLD, so C crosses
    the KLD among the replayed steps: a graph that froze the step it was
    captured at would differ in the loss and in the gradients. A
    ConditionalVAE's labels (new each step) reach the replays through the
    graph's static labels buffer. CategoricalVAE's temperature rises every
    2 steps (a negative ``anneal_rate``), read by each replay's forward
    from its own step; GammaVAE's gamma draw runs under the capture."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_multi_train_step, make_train_step)
    from ctvae_torch.training.state import WARMUP_STEPS
    cfg = dict(name="VanillaVAE", in_channels=3, latent_dim=8,
               hidden_dims=[8, 16], img_size=16)
    if loss_type == "labels":
        cfg.update(name="ConditionalVAE")
    elif loss_type in ("categorical", "gamma"):
        cfg = dict(ZOO_MORE["CategoricalVAE" if loss_type == "categorical"
                            else "GammaVAE"])
    elif loss_type:
        cfg.update(name="BetaVAE", loss_type="B", gamma=10.0,
                   max_capacity=25, Capacity_max_iter=10000)
    exp = dict(LR=5e-3, scheduler_gamma=0.9, weight_decay=0.0)
    g = torch.Generator().manual_seed(6)
    xs = torch.rand(12, 4, 16, 16, 3, generator=g).cuda()
    ys = torch.randint(0, 2, (12, 4, 40), generator=g).float().cuda()

    def batch(i, n=None):
        keys = {"image": xs, "labels": ys} if loss_type == "labels" else {
            "image": xs}
        return {k: v[i] if n is None else v[i:i + n]
                for k, v in keys.items()}

    step = make_train_step("base", M_N=0.5)

    def build():
        m = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
        return create_train_state(m, build_optimizers(exp, m, 3), seed=5)

    if loss_type == "B":
        kld0 = float(step(build(), batch(0))["KLD"])
        cfg.update(Capacity_max_iter=12, max_capacity=2.0 * kld0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, graph = build(), build()
        metrics = [step(eager, batch(i)) for i in range(12)]
        multi = make_multi_train_step("base", 4, M_N=0.5)
        calls = [multi(graph, batch(i, 4)) for i in (0, 4, 8)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert multi.replays == 12 - WARMUP_STEPS
    for i, got in zip((3, 7, 11), calls):
        assert got.keys() == metrics[i].keys()
        for k, v in got.items():
            want = metrics[i][k]
            assert float((v - want).abs()) <= 1e-6 * float(want.abs()), k
    if loss_type == "B":
        C = [2.0 * kld0 / 12 * (s + 1) for s in range(12)]
        above = {float(m["KLD"]) > c for m, c in
                 zip(metrics[WARMUP_STEPS:], C[WARMUP_STEPS:])}
        assert above == {True, False}
    a, b = eager.model.state_dict(), graph.model.state_dict()
    assert any(n.endswith("running_var") for n in a)
    for n, t in a.items():
        assert float((t - b[n]).abs().max()) <= 1e-6 * float(
            t.abs().max()), n
    for oa, ob in zip(eager.optimizers, graph.optimizers):
        for pa, pb in zip(oa.params, ob.params):
            for k, va in oa.adam.state.get(pa, {}).items():
                vb = ob.adam.state[pb][k]
                assert float((va - vb).abs().max()) <= \
                    1e-6 * float(va.abs().max()), k
    assert eager.step == graph.step == 12
    assert torch.equal(eager.generator.get_state(),
                       graph.generator.get_state())


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_ct_model_at_21_heads_on_card_matches_cpu(card, mode):
    """A small CT-MCQ-VAE with TCeleba's 20 actions (21 GAT heads; the
    causal batch A*B = 60 at B = 3): one train forward + backward on the
    card, every kernel launched (the per-head logits and both backward
    kernels too), against the same weights and draws on the CPU (each
    kernel's plain version): the loss and every parameter's gradient."""
    import copy

    from ctvae_torch.models import build_model
    from ctvae_torch.ops import launch_counts
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=20, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=1, causal_hidden_dims=[16, 8],
               noise="off")
    model = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    assert model.ct_layer.graph_transitioner.DenseGATv2Layer_0.heads == 21
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(9)
    x, y = (torch.rand(3, 16, 16, 3, generator=g),
            torch.rand(3, 16, 16, 3, generator=g))
    a = torch.eye(20)[torch.randint(0, 20, (3,), generator=g)]
    before = launch_counts()
    losses = []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        out = m(x.to(dev), input_y=y.to(dev), action=a.to(dev), mode=mode,
                draws=_draws(4, dev), train=True)
        loss = m.loss_function(out)["loss"]
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[k] > before[k] for k in after), (before, after)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        q = cpu_params[name]
        if q.grad is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        scale = max(1.0, float(q.grad.abs().max()))
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, \
            name


def test_card_codec_decodes_as_libjpeg_and_the_rendered_arrays(card,
                                                              tmp_path):
    """The JPEG codec of a machine with a card (nvJPEG): the committed
    libjpeg reference's JPEGs (two colour stand-in images and a grey one)
    decode within 64 levels of libjpeg's pixels, 2 on average (nvJPEG
    12.4 on the H100: 34, 47 and 1 levels, 0.87, 0.94 and 0.013: its
    chroma upsampling is not libjpeg's); the
    stand-in's first 16 images encoded at quality 80 and decoded again
    lie within 160 levels of the arrays they were rendered from, 6 on
    average (libjpeg's own: 106 and 4.5); a missing file raises with its
    name."""
    import os

    from ctvae_torch import native
    from ctvae_torch.data.standins import render_celeba_images
    codec = native.codec()
    assert codec.name == native.default_codec() == "nvjpeg"
    ref = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_jpeg_reference.npz")
    with np.load(ref) as z:
        for key in (k for k in z.files if k.startswith("jpeg_")):
            name = key[len("jpeg_"):]
            path = str(tmp_path / f"{name}.jpg")
            with open(path, "wb") as f:
                f.write(z[key].tobytes())
            got = codec.decode(path).astype(np.int16)
            d = np.abs(got - z[f"decoded_{name}"].astype(np.int16))
            assert got.shape == z[f"decoded_{name}"].shape, name
            assert d.max() <= 64 and d.mean() <= 2.0, (name, d.max(),
                                                       d.mean())
    images = render_celeba_images(range(1, 17))
    paths = [str(tmp_path / f"{i}.jpg") for i in range(16)]
    codec.encode_batch(images, paths, 80)
    d = np.abs(codec.decode_batch(paths).astype(np.int16)
               - images.astype(np.int16))
    assert d.max() <= 160 and d.mean() <= 6.0, (d.max(), d.mean())
    with pytest.raises(OSError, match="nope.jpg cannot be read"):
        codec.decode_batch(paths[:2] + [str(tmp_path / "nope.jpg")])


#: the last of the registry at small widths (DFCVAE's VGG needs img 32)
ZOO_LAST = {
    "MSSIMVAE": dict(name="MSSIMVAE", latent_dim=8, in_channels=3,
                     hidden_dims=[8, 16], img_size=32),
    "DFCVAE": dict(name="DFCVAE", latent_dim=8, in_channels=3,
                   hidden_dims=[8, 16], img_size=32,
                   allow_random_features=True),
    "FactorVAE": dict(name="FactorVAE", latent_dim=8, gamma=6.4,
                      in_channels=3, hidden_dims=[8, 16], img_size=32),
}


@pytest.mark.parametrize("name", list(ZOO_LAST))
def test_last_zoo_train_steps_on_card_match_cpu(card, name, monkeypatch):
    """MSSIMVAE's, DFCVAE's and FactorVAE's train step (FactorVAE's two
    optimizer calls of one batch: ``configs/factorvae.yaml``'s
    ``LR_2`` / ``submodel``) on the card against the same weights and
    CPU-drawn draws on the CPU: metrics rtol 1e-4, every gradient within
    1e-4 of max(1, its leaf's scale) (DFCVAE's 1e-3: a max-pool's argmax in
    the VGG moves with the last bits of the reconstruction, and routes a
    feature gradient elsewhere), every parameter within what the
    gradients' difference allows after Adam, the buffers 1e-5 / rtol 1e-4
    (DFCVAE's VGG bit-unchanged); FactorVAE's second call moves the
    discriminator's parameters alone."""
    import copy

    from ctvae_torch.models import build_model
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    model = build_model(ZOO_LAST[name], device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    cpu_model = copy.deepcopy(model).to("cpu")
    vgg = {n: t.clone() for n, t in model.named_buffers()
           if n.startswith("feature_network.")}
    batch = {"image": torch.rand(4, 32, 32, 3,
                                 generator=torch.Generator().manual_seed(5))}
    exp = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
    if name == "FactorVAE":
        exp.update(LR_2=5e-3, scheduler_gamma_2=0.95,
                   submodel="discriminator")
    rel = 1e-3 if name == "DFCVAE" else 1e-4
    kept = tstate._grads
    for idx in range(2 if name == "FactorVAE" else 1):
        metrics, grads, params = [], [], []

        def grads_of(*args):
            out = kept(*args)
            grads.append({n: p.grad.detach().cpu().clone()
                          for n, p in args[0].model.named_parameters()
                          if p.grad is not None})
            return out

        monkeypatch.setattr(tstate, "_grads", grads_of)
        monkeypatch.setattr(tstate, "Draws",
                            lambda gen, device: _CpuDraws(7 + idx, device))
        for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
            if idx == 0:
                m.state = tstate.create_train_state(
                    m, topt.build_optimizers(exp, m, 4))
            params.append({n: p.detach().clone()
                           for n, p in m.named_parameters()})
            metrics.append({k: float(v) for k, v in tstate.make_train_step(
                "base", M_N=0.5, optimizer_idx=idx)(m.state, {
                    k: v.to(dev) for k, v in batch.items()}).items()})
        torch.cuda.synchronize()
        assert model.state.step == cpu_model.state.step == idx + 1
        assert metrics[0].keys() == metrics[1].keys()
        for k, v in metrics[1].items():
            np.testing.assert_allclose(metrics[0][k], v, rtol=1e-4,
                                       atol=1e-6)
        assert grads[0].keys() == grads[1].keys()
        for n, g in grads[1].items():
            scale = max(1.0, float(g.abs().max()))
            assert float((grads[0][n] - g).abs().max()) <= rel * scale, n
        cpu_params = dict(cpu_model.named_parameters())
        for n, p in model.named_parameters():
            diff = (grads[0][n] - grads[1][n]).abs() if n in grads[1] \
                else torch.zeros_like(cpu_params[n])
            tol = 2e-6 + exp["LR"] / 1e-8 * diff
            assert bool(((p.detach().cpu() - cpu_params[n].detach()).abs()
                         <= tol).all()), n
            moved = not torch.equal(p.detach(), params[0][n])
            if idx == 1:
                assert moved == n.startswith("discriminator."), n
        cpu_buffers = dict(cpu_model.named_buffers())
        for n, t in model.named_buffers():
            np.testing.assert_allclose(t.cpu().numpy(),
                                       cpu_buffers[n].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=n)
        # the next call from the same parameters on both sides
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(cpu_params[n].to(card))
    for n, t in vgg.items():
        assert torch.equal(dict(model.named_buffers())[n], t), n


def test_permutation_draws_on_card(card):
    """``Draws.permutation`` on a CUDA generator (FactorVAE's permuted
    latent): int64 on the card, every row a permutation of range(n), rows
    differing, repeated by a reseeded generator."""
    from ctvae_torch.models.base import Draws
    p = [Draws(torch.Generator("cuda").manual_seed(3), card).permutation(
        64, 128) for _ in range(2)]
    assert torch.equal(p[0], p[1])
    assert p[0].device.type == "cuda" and p[0].dtype == torch.int64
    assert torch.equal(p[0].sort(1).values,
                       torch.arange(128, device=card).expand(64, 128))
    assert len({tuple(r) for r in p[0].cpu().tolist()}) == 64


# --- the kernels as custom ops, keyed draws and exported artifacts ---------

def _op_cases(rng):
    """{op name: (CUDA args, the indices of its float outputs' checks)}:
    one call of each ``ctvae::`` op at small ragged shapes."""
    from ctvae_torch.ops import library
    B, S, T, H = 3, 9, 13, 33
    xl, xr = _t(rng, B, S, H), _t(rng, B, T, H)
    w2, b1, b2 = _t(rng, B, H), _t(rng, H), _t(rng, B)
    pw = (xl, xr, w2, b1, b2)
    out = library.pairwise_fwd(*pw, 0.01)
    gat = _gat_args(rng, 2, 9, 11, 3, 5)
    _, alpha = library.gat_fwd_alpha(*gat, 0.2)
    K, F = 2, 40
    lg = (_t(rng, B, S, K, F), _t(rng, B, T, K, F),
          torch.from_numpy(rng.uniform(size=(B, S, T)).astype(
              np.float32)).cuda(), _t(rng, B, K, F, scale=0.3),
          _t(rng, B, K, F, scale=0.3))
    return {"vq_l2_argmin": (_t(rng, 37, 8), _t(rng, 9, 8)),
            "pairwise_fwd": (*pw, 0.01),
            "pairwise_bwd": (*pw, out, _t(rng, B, S, T), 0.01),
            "gat_fwd": (*gat, 0.2), "gat_fwd_alpha": (*gat, 0.2),
            "gat_bwd": (*gat, alpha, _t(rng, 2, 11, 3, 5), 0.2),
            "gat_logits_fwd": (*lg, 0.2),
            "gat_logits_bwd": (*lg, _t(rng, B, S, T, K), 0.2)}


@pytest.mark.parametrize("name", [
    "vq_l2_argmin", "pairwise_fwd", "pairwise_bwd", "gat_fwd",
    "gat_fwd_alpha", "gat_bwd", "gat_logits_fwd", "gat_logits_bwd"])
def test_custom_op_matches_plain(card, name):
    """Each ``ctvae::`` op on CUDA tensors (its kernel: one launch on its
    counter) against the same op on CPU copies (the plain version, the
    backward ones the plain autograd), within 1e-5 of each output's
    scale; outputs in the fake kernel's shapes and dtypes."""
    from ctvae_torch.ops import launch_counts
    from ctvae_torch.ops.common import custom_ops
    args = _op_cases(np.random.default_rng(7))[name]
    op = getattr(custom_ops(), name)
    kernel = {"gat_fwd_alpha": "gat_fwd"}.get(name, name)
    before = launch_counts()
    got = op(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {kernel: 1}
    want = op(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype
        assert g.is_contiguous()
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale, name


def test_keyed_draws_equal_on_cpu_and_card(card):
    """``KeyedDraws`` of one key on both devices: the integer draws bit
    for bit, the float transforms within the last bits of the devices'
    log / cos / tan (rtol 1e-5 over each draw's scale)."""
    from ctvae_torch.serving.draws import KeyedDraws
    for key in (0, 7, -3, 2 ** 40 + 5):
        d = [KeyedDraws(torch.tensor(key), dev) for dev in ("cpu", card)]
        for kind, call in (
                ("uniform", lambda p: p.uniform((64, 33))),
                ("randint", lambda p: p.randint(-3, 11, (500,))),
                ("bernoulli", lambda p: p.bernoulli(0.3, (7, 9))),
                ("permutation", lambda p: p.permutation(16, 40)),
                ("normal", lambda p: p.normal((4, 1000))),
                ("gumbel", lambda p: p.gumbel((3, 200, 2))),
                ("cauchy", lambda p: p.cauchy((2, 300))),
                ("gamma", lambda p: p.gamma(torch.full(
                    (800,), 8.5, device=p.device)))):
            cpu, gpu = (call(p) for p in d)
            assert gpu.device.type == "cuda" and gpu.dtype == cpu.dtype
            if kind in ("uniform", "randint", "bernoulli", "permutation"):
                assert torch.equal(gpu.cpu(), cpu), (key, kind)
            else:
                scale = max(1.0, float(cpu.abs().max()))
                assert float((gpu.cpu() - cpu).abs().max()) <= \
                    1e-5 * scale, (key, kind)


def test_ct_artifact_serves_on_card_and_cpu(card, tmp_path):
    """A small CT-MCQ-VAE's five entry points exported on the card with a
    symbolic batch, saved and loaded: on the card at B = 4 and 3, against
    the live port on the same key (1e-4 / 1e-5), launching the four
    forward kernels and no backward one; the same files moved to the CPU
    (the plain versions) at B = 2 against the card's output (1e-4)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.ops import launch_counts
    from ctvae_torch.serving import export, inference
    params = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
                  action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
                  img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
                  gamma=1.5)
    model = build_model(params, device=card)
    rng = np.random.default_rng(5)

    def arrays(name, B):
        x, y = (torch.from_numpy(rng.uniform(size=(B, 16, 16, 3)).astype(
            np.float32)).to(card) for _ in range(2))
        a = torch.nn.functional.one_hot(torch.from_numpy(
            rng.integers(0, 8, B)), 8).float().to(card)
        return {"reconstruct": (x,), "encode": (x,), "sample": (),
                "apply_action": (x, y, a), "classify_action": (x, y)}[name]

    key = torch.tensor(9, device=card)
    entries = {n: export.EntryPoint(model, n, num_samples=5)
               for n in inference.available_fns(model)}
    art = export.save_artifact(str(tmp_path / "art"), {
        n: export.export_fn(e, (key, *arrays(n, 4)),
                            poly_batch=n != "sample")
        for n, e in entries.items()})
    fns, manifest = export.load_artifact(art)
    cpu_fns, _ = export.load_artifact(art, device="cpu")
    assert manifest["functions"]["apply_action"]["in_specs"][1] == \
        "float32[b, 16, 16, 3]"
    before = launch_counts()
    for name, entry in entries.items():
        for B in (4, 3):
            args = arrays(name, B)
            got = fns[name](key, *args)
            with torch.inference_mode():
                want = entry(key, *args)
            assert got.is_cuda and bool(torch.isfinite(got).all())
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        args = arrays(name, 2)
        on_card = fns[name](key, *args)
        on_cpu = cpu_fns[name](key.cpu(), *(a.cpu() for a in args))
        assert not on_cpu.is_cuda
        np.testing.assert_allclose(on_cpu.numpy(), on_card.cpu().numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
    torch.cuda.synchronize()
    after = launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    assert all(moved[k] > 0 for k in ("vq_l2_argmin", "pairwise_fwd",
                                      "gat_fwd", "gat_logits_fwd")), moved
    assert not any(moved[k] for k in ("pairwise_bwd", "gat_bwd",
                                      "gat_logits_bwd")), moved


@pytest.mark.parametrize("mode", ["base", "action", "causal"])
def test_data_parallel_world_1_over_nccl_is_bit_equal(card, mode):
    """A process group of one rank over NCCL: a small CT-MCQ-VAE's four
    data-parallel steps (the draws through ``ShardedDraws``, the gradient
    bucket summed and divided by 1, the metrics averaged over one rank)
    equal four plain steps from an equal state bit for bit: parameters,
    Adam moments, the last metrics and the generator."""
    import socket

    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import destroy, init_distributed
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
               action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
               img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
               noise="off")
    exp = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group = init_distributed(device=torch.device(card),
                             init_method=f"tcp://127.0.0.1:{port}", rank=0,
                             world_size=1)
    try:
        states = []
        for g in (None, group):
            m = build_model(cfg, device=card,
                            generator=torch.Generator("cuda").manual_seed(0))
            states.append(create_train_state(m, build_optimizers(exp, m, 3),
                                             seed=5, group=g))
        gen = torch.Generator().manual_seed(6)
        batches = [{"image": torch.rand(3, 16, 16, 3, generator=gen),
                    "input_y": torch.rand(3, 16, 16, 3, generator=gen),
                    "action": torch.eye(8)[torch.randint(0, 8, (3,),
                                                         generator=gen)]}
                   for _ in range(4)]
        step = make_train_step(mode)
        metrics = [[step(s, {k: v.to(card) for k, v in b.items()})
                    for b in batches][-1] for s in states]
        plain, dp = states
        for a, b in zip(plain.model.parameters(), dp.model.parameters()):
            assert torch.equal(a, b)
        for oa, ob in zip(plain.optimizers, dp.optimizers):
            for pa, pb in zip(oa.params, ob.params):
                for k, va in oa.adam.state.get(pa, {}).items():
                    assert torch.equal(va, ob.adam.state[pb][k]), k
        assert metrics[0].keys() == metrics[1].keys()
        for k, v in metrics[0].items():
            assert torch.equal(v, metrics[1][k]), k
        assert torch.equal(plain.generator.get_state(),
                           dp.generator.get_state())
    finally:
        destroy()


def _gloo_ranks_on_the_card(payload, tmp_path, world=2, timeout=300):
    """``tests/torch_dp_ranks.py steps`` on ``world`` gloo ranks sharing
    the card (NCCL refuses two ranks on one card): each rank's results."""
    import os
    import socket
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    path = str(tmp_path / "payload.pt")
    torch.save(payload, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests), tests]))
    log = open(tmp_path / "ranks.log", "w")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(tests, "torch_dp_ranks.py"), "steps",
         str(r), str(world), str(port), path, str(tmp_path)],
        env=env, stdout=log, stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        log.close()
    text = (tmp_path / "ranks.log").read_text()
    assert all(p.returncode == 0 for p in procs), text
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    return [o["result"] for o in outs]


def _assert_like_one_process(got, want, lr, tol=1e-5):
    """A rank's one-step run against one process's: each metric within
    ``tol`` (atol and rtol), each gradient within ``tol`` of its leaf's
    scale, each parameter within ``tol`` plus Adam's reach of the
    gradients' difference."""
    for k, v in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k].cpu().numpy(),
                                   v.cpu().numpy(), atol=tol, rtol=tol)
    for n, g in want["grads"][0].items():
        d = (got["grads"][0][n] - g).abs()
        assert float(d.max()) <= tol * max(1.0, float(g.abs().max())), n
        p_d = (got["params"][n] - want["params"][n]).abs()
        assert bool((p_d <= tol + lr / 1e-8 * d).all()), n


@pytest.mark.parametrize("which", ["fsdp", "cross_batch"])
def test_two_gloo_ranks_on_the_card_equal_one_process(card, which,
                                                      tmp_path):
    """Two gloo ranks on the card, each 2 rows of a global batch of 4:
    ``fsdp``, one step per mode of a small CT-MCQ-VAE under FSDP
    (``fsdp_min_size`` 64, the slices gathered); ``cross_batch``, one
    step of WAE_MMD (the MMD on the global batch). Each against one
    process on the card on the global batch, and the ranks' parameters
    bit-identical."""
    from torch_dp_ranks import run_steps
    from ctvae_torch.models import build_model
    gen = torch.Generator().manual_seed(7)
    if which == "fsdp":
        cfg = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
                   action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
                   img_size=16, codebooks=2, causal_hidden_dims=[16, 8],
                   noise="off")
        modes = ("base", "action", "causal")

        def batch():
            return {"image": torch.rand(4, 16, 16, 3, generator=gen).numpy(),
                    "input_y": torch.rand(4, 16, 16, 3,
                                          generator=gen).numpy(),
                    "action": torch.eye(8)[torch.randint(
                        0, 8, (4,), generator=gen)].numpy()}
    else:
        cfg = dict(name="WAE_MMD", in_channels=3, latent_dim=8,
                   hidden_dims=[8, 16], img_size=16, reg_weight=100,
                   kernel_type="imq")
        modes = ("base",)

        def batch():
            return {"image": torch.rand(4, 16, 16, 3, generator=gen).numpy()}
    exp = dict(LR=5e-4, scheduler_gamma=0.9, weight_decay=0.0)
    model = build_model(cfg, device=card,
                        generator=torch.Generator("cuda").manual_seed(0))
    spec = {"cfg": cfg, "exp": exp, "device": "cuda",
            "state_dict": {k: v.cpu() for k, v in
                           model.state_dict().items()},
            "runs": [{"seed": 3 + i, "steps": [(mode, batch(), None)]}
                     for i, mode in enumerate(modes)]}
    if which == "fsdp":
        spec["fsdp"] = 64
    r0, r1 = (r["m"] for r in _gloo_ranks_on_the_card(
        {"models": {"m": spec}}, tmp_path))
    want = run_steps(spec)
    for i in range(len(modes)):
        assert (which == "fsdp") == bool(r0[i].get("axes"))
        for n, t in r0[i]["params"].items():
            assert torch.equal(t, r1[i]["params"][n]), n
        _assert_like_one_process(r0[i], want[i], exp["LR"])


# --- the bfloat16 instantiations ------------------------------------------

#: one bfloat16 ulp, relative (2^-8: 8 significant bits); a bfloat16
#: output of the kernel and of the plain version is the same float32 value
#: up to the order of its sums, rounded once, so the two are at most one
#: spacing (2^-7 relative at worst) apart, plus 1e-5 of the output's scale
#: where a sum cancels
BF16_ULP = 2.0 ** -8


def _bf16_case(rng, name, shape, per_sample=True):
    """CUDA arguments of op ``name`` at ``shape``, every float input that
    JAX holds in the compute dtype in bfloat16 (GAT's alpha residual in
    float32, from the plain forward)."""
    from ctvae_torch.ops import library

    def b(*s, scale=1.0):
        return _t(rng, *s, scale=scale).to(torch.bfloat16)
    if name.startswith("pairwise"):
        B, S, T, H = shape
        pshape = (B, H) if per_sample else (H,)
        pw = (b(B, S, H, scale=0.5), b(B, T, H, scale=0.5),
              b(*pshape, scale=H ** -0.5), b(*pshape, scale=0.1),
              b(*pshape[:-1], scale=0.1))
        if name == "pairwise_fwd":
            return (*pw, 0.01)
        out = library.pairwise_fwd(*(a.cpu() for a in pw), 0.01).cuda()
        dout = b(B, S, T)
        dout[:, ::3] = 0.0            # rows without a gradient
        return (*pw, out, dout, 0.01)
    if name.startswith("gat_logits"):
        B, S, T, K, F = shape
        xl, xr, adj, we, att = (
            a.to(torch.bfloat16)
            for a in _logits_args(rng, B, S, T, K, F, per_sample))
        if name == "gat_logits_fwd":
            return (xl, xr, adj, we, att, 0.2)
        d_e = b(B, S, T, K)
        d_e[:, :, 3] = 0.0
        return (xl, xr, adj, we, att, d_e, 0.2)
    B, S, T, H, F = shape
    xl, xr, adj, mask, we, att = _gat_args(rng, B, S, T, H, F)
    xl, xr, adj, we, att = (a.to(torch.bfloat16)
                            for a in (xl, xr, adj, we, att))
    if name in ("gat_fwd", "gat_fwd_alpha"):
        return (xl, xr, adj, mask, we, att, 0.2)
    _, alpha = library.gat_fwd_alpha(
        *(a.cpu() for a in (xl, xr, adj, mask, we, att)), 0.2)
    return (xl, xr, adj, mask, we, att, alpha.cuda(), b(B, T, H, F), 0.2)


BF16_CASES = [
    # pairwise: ragged S != T, Hd not a multiple of 4 (element staging),
    # the headline's A*B = 192, and S = T past 120 (dout read from device
    # memory) up to the largest tile
    ("pairwise", (3, 7, 13, 24)), ("pairwise", (3, 65, 13, 801)),
    ("pairwise", (16, 64, 64, 800)), ("pairwise", (192, 64, 64, 800)),
    ("pairwise", (3, 128, 128, 100)), ("pairwise", (2, 152, 152, 100)),
    # GAT: F below a warp and not a multiple of 4, the headline's 65
    # nodes, T = 16, and past 124 nodes (the scratch over the dout tile)
    ("gat", (3, 9, 9, 3, 5)), ("gat", (3, 7, 11, 2, 40)),
    ("gat", (3, 65, 65, 13, 100)), ("gat", (3, 16, 16, 2, 40)),
    ("gat", (3, 129, 129, 13, 100)), ("gat", (2, 133, 133, 2, 100)),
    # per-head logits: F = 5 (element staging), the headline B = 16 and
    # A*B = 192 at K = 2, 129 nodes
    ("gat_logits", (3, 9, 9, 2, 5)), ("gat_logits", (3, 7, 11, 3, 40)),
    ("gat_logits", (16, 65, 65, 2, 64)), ("gat_logits", (192, 65, 65, 2, 64)),
    ("gat_logits", (3, 129, 129, 13, 100))]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kernel,shape,per_sample", [
    (k, s, p) for k, s in BF16_CASES
    # the GAT's we / att are shared only
    for p in ((False,) if k == "gat" else (False, True))])
def test_bf16_kernels_match_plain(card, kernel, shape, direction,
                                  per_sample):
    """Each kernel's bfloat16 instantiation (its op on CUDA tensors, one
    launch) against the same op on CPU copies, the plain version at
    bfloat16: outputs in the same dtypes (bfloat16 but GAT's alpha and
    the float32 sums the ops cast once), within two bfloat16 ulps of each
    element plus 1e-5 of the output's scale; two runs agree bit for bit."""
    from ctvae_torch.ops import launch_counts
    from ctvae_torch.ops.common import custom_ops
    name = f"{kernel}_{direction}"
    op_name = "gat_fwd_alpha" if name == "gat_fwd" else name
    rng = np.random.default_rng(sum(shape) + per_sample)
    args = _bf16_case(rng, op_name, shape, per_sample)
    op = getattr(custom_ops(), op_name)
    before = launch_counts()
    got = op(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {name: 1}
    want = op(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, i
        g, w = g.cpu().float(), w.float()
        scale = max(1.0, float(w.abs().max()))
        err = (g - w).abs() - 2 * BF16_ULP * w.abs()
        assert float(err.max()) <= 1e-5 * scale, (name, i, float(err.max()))
    again = op(*args)
    again = (again,) if torch.is_tensor(again) else again
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def test_bf16_kernels_refuse_mixed_dtypes(card):
    """A kernel argument whose dtype is not the main input's raises (no
    silent cast), and a dtype without an instantiation too."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops import pairwise_flash as pf
    rng = np.random.default_rng(3)
    xl, xr, w2, b1, b2 = _bf16_case(rng, "pairwise_fwd", (2, 5, 5, 8))[:5]
    with pytest.raises(TypeError):
        pf.flash_pairwise_cuda(xl, xr, w2.float(), b1, b2, 0.01)
    with pytest.raises(TypeError):
        pf.flash_pairwise_cuda(xl.half(), xr.half(), w2.half(), b1.half(),
                               b2.half(), 0.01)
    args = list(_bf16_case(rng, "gat_fwd", (2, 9, 9, 3, 8)))
    args[2] = args[2].float()
    with pytest.raises(TypeError):
        gf.flash_gat_cuda(*args)
