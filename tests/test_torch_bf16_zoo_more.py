"""The members on the standard backbone with their own heads, draws or
losses at ``dtype: bfloat16`` against the JAX package at bfloat16: IWAE
and MIWAE (S and M x S samples through the bfloat16 decoder, the
log-weights in float32), SWAE (``normal`` / ``cauchy`` projections in
float32), JointVAE (its categorical ``fc_z``), VampVAE (the pseudo-inputs
through a bfloat16 ``embed_pseudo`` and the same encoder) at
tests/test_torch_zoo_more.py's small widths, and MSSIMVAE (both
windows), DFCVAE (its frozen VGG in float32 on the float32 images, as
JAX's takes no ``dtype``), FactorVAE (the discriminator's layers, both
optimizers' steps) and TwoStageVAE (both stages: the stage-2 MLPs and
heads) at tests/test_torch_zoo_last.py's.

Per case: the forward and ``loss_function`` at ``train`` False and True
(every draw replayed; FactorVAE's loss at both optimizer indices), the
float32 outputs within 4 bfloat16 ulps of their scale and the losses
within 5 (2 %); one train step held by ``assert_zoo_step`` (see
tests/torch_bf16_common.py and tests/test_torch_bf16.py's module doc).
DFCVAE's loss is not smooth (a max-pool's argmax or a ReLU's side in the
VGG moves with the last bits of the reconstruction), which that rule
covers: each gradient within twice JAX's distance of the port's own
float32 step on the same values.
"""

import pytest
import torch

import test_torch_zoo_last as last
import test_torch_zoo_more as more
from torch_bf16_common import (_train_step_pair, assert_zoo_forward,
                               assert_zoo_step, zoo_forward_pair, zoo_pair)
from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MORE = ("IWAE", "MIWAE", "SWAE-normal", "SWAE-cauchy", "JointVAE",
        "VampVAE")
LAST = tuple(last.CASES)
_PAIRS = {}


def _jax_two_stage(cfg):
    import jax.numpy as jnp
    return last._build_jax(dict(cfg, dtype=jnp.dtype(cfg["dtype"]).type))


def _case(case: str):
    """(module of the case, model_params, exp_params, global step, the
    port's build function or None)."""
    if case in MORE:
        cfg, step, _ = more.CASES[case]
        return more, cfg, more.EXP, step, None
    cfg, exp = last.CASES[case][:2]
    two = cfg["name"] == "TwoStageVAE"
    return last, cfg, exp, 0, last._build_port if two else None


def _pair(case: str):
    if case not in _PAIRS:
        mod, cfg, _, _, build = _case(case)
        _PAIRS[case] = zoo_pair(
            cfg, mod._images(0, 2), port_build=build,
            jax_build=_jax_two_stage if build else None)
    return _PAIRS[case]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", MORE + LAST)
def test_forward_and_loss_match_jax_at_bf16(case, train, monkeypatch):
    """The forward and the loss of ``case`` at bfloat16 against JAX's, at
    the case's global step and ``M_N`` 0.5, its draws replayed."""
    mod, _, _, step, _ = _case(case)
    idxs = (0, 1) if case == "FactorVAE" else (0,)
    assert_zoo_forward(*zoo_forward_pair(
        monkeypatch, _pair(case), mod._images(21), train, step=step,
        M_N=mod.M_N, idxs=idxs))


@pytest.mark.parametrize("case", MORE + LAST)
def test_train_step_matches_jax_at_bf16(case, monkeypatch):
    """One train step (optimizer 0) of ``case`` at bfloat16 against
    JAX's, at ``M_N`` 0.5 and the case's global step."""
    mod, cfg, exp, step, build = _case(case)
    assert_zoo_step(_train_step_pair(
        monkeypatch, _pair(case), "base", cfg, exp=exp,
        b={"image": mod._images(11)}, M_N=mod.M_N, step=step, build=build,
        heads=True), exp["LR"])


def test_factor_vae_discriminator_step_matches_jax_at_bf16(monkeypatch):
    """FactorVAE's second optimizer (``LR_2``, ``submodel:
    discriminator``) at bfloat16: one step of the discriminator's loss
    against JAX's, every parameter outside the discriminator left as it
    was."""
    _, cfg, exp, _, _ = _case("FactorVAE")
    pair = _pair("FactorVAE")
    before = {n: p.clone() for n, p in pair[2].named_parameters()}
    out = _train_step_pair(monkeypatch, pair, "base", cfg, exp=exp,
                           b={"image": last._images(11)}, M_N=last.M_N,
                           optimizer_idx=1, heads=True)
    assert set(out[1][1]) == {"loss", "D_TC_Loss", "grad_norm"}
    assert_zoo_step(out, exp["LR_2"])
    for n, p in out[1][0].named_parameters():
        assert n.startswith("discriminator.") or torch.equal(p, before[n]), n


def test_dfc_vae_vgg_stays_float32():
    """DFCVAE at bfloat16: the frozen VGG holds float32 buffers and no
    ``compute_dtype``, and its taps of the float32 reconstruction are
    float32."""
    _, _, tm = _pair("DFCVAE")
    vgg = tm.feature_network
    assert not hasattr(vgg, "compute_dtype")
    assert {b.dtype for b in vgg.buffers()} == {torch.float32}
    with torch.no_grad():
        out = tm(torch.from_numpy(last._images(3)), draws=None)
    assert out["recons"].dtype == torch.float32
    assert all(f.dtype == torch.float32 for f in out["recons_features"])
