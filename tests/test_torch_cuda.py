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


@pytest.mark.parametrize("n,k,d", [(37, 8, 4), (1000, 64, 128), (5, 70, 33)])
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
@pytest.mark.parametrize("S,T,H", [(7, 7, 24), (9, 13, 800), (64, 64, 33)])
def test_pairwise_kernel_matches_plain(card, per_sample, S, T, H):
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    rng = np.random.default_rng(S * T + H)
    B = 3
    pshape = (B, H) if per_sample else (H,)
    args = (_t(rng, B, S, H, scale=0.5), _t(rng, B, T, H, scale=0.5),
            _t(rng, *pshape, scale=H ** -0.5), _t(rng, *pshape, scale=0.1),
            _t(rng, *pshape[:-1], scale=0.1))
    before = pf.launches
    got = pf.flash_pairwise(*args, 0.01)
    torch.cuda.synchronize()
    assert pf.launches == before + 1
    want = fused_pairwise_scores(*args, 0.01)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,H,F", [(9, 3, 5), (65, 13, 100), (33, 2, 128)])
def test_gat_kernel_matches_plain(card, T, H, F):
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.gat import replace_self_loops
    rng = np.random.default_rng(T + F)
    B = 4
    xl, xr = _t(rng, B, T, H, F), _t(rng, B, T, H, F)
    we, att = _t(rng, H, F, scale=0.3), _t(rng, H, F, scale=0.3)
    raw = torch.rand(B, T, T, device="cuda")
    raw = raw * (torch.rand(B, T, T, device="cuda") < 0.5)
    adj, mask = replace_self_loops(raw)
    mask[:, :, 2] = False        # a target with no incoming edge
    args = (xl, xr, adj.contiguous(), mask.contiguous(), we, att, 0.2)
    before = gf.launches
    got = gf.flash_gat(*args)
    torch.cuda.synchronize()
    assert gf.launches == before + 1
    want = gf.flash_gat_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)
    assert not got[:, 2].any()


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
