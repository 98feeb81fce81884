"""The members with their own layers at ``dtype: bfloat16`` against the
JAX package at bfloat16: BetaTCVAE (its k4-s2 convs and ``fc``, no
BatchNorm), CategoricalVAE at step 0 and 5 (its ``fc_z``; the
temperature in float32), GammaVAE (the softmax heads on float32 logits,
the gamma draws in float32), HVAE (both heads, ``embed_z2_code``,
``embed_data``, the prior head widened to float32), LVAE (its rungs'
convs and heads, the ladders' BatchNorm over [B, D], its own decoder) at
tests/test_torch_zoo_more.py's small widths, and ConditionalVAE (the
labels widened to float32 as JAX's ``upcast32``) at
tests/test_torch_celeba.py's.

Per case: the forward and ``loss_function`` at ``train`` False and True
(every draw replayed), the float32 outputs within 4 bfloat16 ulps of
their scale and the losses within 5 (2 %); one train step held by
``assert_zoo_step`` (see tests/torch_bf16_common.py and
tests/test_torch_bf16.py's module doc).
"""

import numpy as np
import pytest
import torch

import test_torch_celeba as celeba
import test_torch_zoo_more as more
from torch_bf16_common import (_train_step_pair, assert_zoo_forward,
                               assert_zoo_step, zoo_forward_pair, zoo_pair)
from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OWN = ("BetaTCVAE", "CategoricalVAE-step0", "CategoricalVAE-step5",
       "GammaVAE", "HVAE", "LVAE")
CASES = OWN + ("ConditionalVAE",)
_PAIRS = {}


def _inputs(case: str, seed: int):
    """(images, labels or None) of ``case``'s size."""
    if case == "ConditionalVAE":
        return celeba._inputs(seed)
    return more._images(seed), None


def _case(case: str):
    """(model_params, exp_params, global step)."""
    if case == "ConditionalVAE":
        return celeba.CVAE, celeba.EXP, 0
    cfg, step, _ = more.CASES[case]
    return cfg, more.EXP, step


def _pair(case: str):
    if case not in _PAIRS:
        x, y = _inputs(case, 0)
        _PAIRS[case] = zoo_pair(_case(case)[0], x[:2],
                                labels=None if y is None else y[:2])
    return _PAIRS[case]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_jax_at_bf16(case, train, monkeypatch):
    """The forward and the loss of ``case`` at bfloat16 against JAX's, at
    the case's global step and ``M_N`` 0.5, its draws replayed."""
    x, y = _inputs(case, 21)
    assert_zoo_forward(*zoo_forward_pair(
        monkeypatch, _pair(case), x, train, labels=y, step=_case(case)[2],
        M_N=more.M_N))


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_jax_at_bf16(case, monkeypatch):
    """One train step of ``case`` at bfloat16 against JAX's, at ``M_N``
    0.5 and the case's global step (ConditionalVAE's batch with its
    labels)."""
    cfg, exp, step = _case(case)
    x, y = _inputs(case, 11)
    b = {"image": x} if y is None else {"image": x, "labels": y}
    assert_zoo_step(_train_step_pair(
        monkeypatch, _pair(case), "base", cfg, exp=exp, b=b, M_N=more.M_N,
        step=step, heads=True), exp["LR"])


def test_own_layers_compute_in_bf16():
    """Every Dense, Conv and ConvTranspose of these members is a layer of
    ``ops/layers.py`` computing in bfloat16 (none is left to torch's own
    at float32), each BatchNorm returns bfloat16 with float32
    statistics, and the heads come back in float32: HVAE's prior head,
    LVAE's rungs and ladders, GammaVAE's softmaxes, CategoricalVAE's and
    ConditionalVAE's."""
    from ctvae_torch.models.backbones import BatchNorm
    from ctvae_torch.ops import layers
    for case in CASES:
        tm = _pair(case)[2]
        for name, m in tm.named_modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d,
                              torch.nn.ConvTranspose2d)):
                assert isinstance(m, (layers.Linear, layers.Conv2d,
                                      layers.ConvTranspose2d)), (case, name)
            if isinstance(m, (layers.Linear, layers.Conv2d,
                              layers.ConvTranspose2d, BatchNorm)):
                assert m.compute_dtype == torch.bfloat16, (case, name)
    x, y = _inputs("HVAE", 3)
    tm = _pair("HVAE")[2]
    with torch.no_grad():
        z2 = torch.zeros(x.shape[0], tm.latent2_dim)
        out = tm(torch.from_numpy(x),
                 draws=type("Zero", (), {"normal": staticmethod(
                     lambda shape: torch.zeros(shape))})())
    assert out["z1_p_mu"].dtype == out["z1_p_log_var"].dtype == torch.float32
    assert tm.recons_z1_mu(z2).dtype == torch.bfloat16
    lv = _pair("LVAE")[2]
    with torch.no_grad():
        post = lv.encode(torch.from_numpy(_inputs("LVAE", 3)[0]))
        ladder = lv.ladders_0(post[-1][0], train=False)
    assert all(t.dtype == torch.float32 for p in post for t in p)
    assert all(t.dtype == torch.float32 for t in ladder)
    assert np.isfinite(out["recons"].numpy()).all()
