"""The standard backbone's loss-only members of the zoo at ``dtype:
bfloat16`` against the JAX package at bfloat16: BetaVAE H and B (each
side of ``Capacity_max_iter``), LogCoshVAE, DIPVAE, InfoVAE and WAE_MMD
(``imq``, ``rbf``; its ``fc_z`` a bfloat16 layer whose ``z`` comes back
in float32), at tests/test_torch_zoo.py's small widths and cases.

Per case: the forward and ``loss_function`` at ``train`` False and True
(every draw replayed), the float32 outputs within 4 bfloat16 ulps of
their scale and the losses within 5 (2 %); one train step
(``assert_zoo_step``: the metrics within 2 %, ``grad_norm`` and every
gradient leaf as accurate as JAX's against the port's own float32 step
on the same values and draws, every parameter after Adam, BatchNorm's
float32 running statistics within 4 ulps of their scale).
tests/test_torch_bf16.py's module doc says why the step is held so.
"""

import numpy as np
import pytest
import torch

from test_torch_zoo import CASES, EXP, M_N, _images
from torch_bf16_common import (_train_step_pair, assert_zoo_forward,
                               assert_zoo_step, zoo_forward_pair, zoo_pair)
from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_CASES = [c for c in CASES if not c.startswith(("VanillaVAE", "VQVAE"))]
_PAIRS = {}


def _pair(case: str):
    if case not in _PAIRS:
        _PAIRS[case] = zoo_pair(CASES[case][0], _images(0, 2))
    return _PAIRS[case]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", BF16_CASES)
def test_forward_and_loss_match_jax_at_bf16(case, train, monkeypatch):
    """The forward and the loss of ``case`` at bfloat16 against JAX's, at
    the case's global step and ``M_N`` 0.5, its draws replayed."""
    assert_zoo_forward(*zoo_forward_pair(
        monkeypatch, _pair(case), _images(21), train, step=CASES[case][1],
        M_N=M_N))


@pytest.mark.parametrize("case", BF16_CASES)
def test_train_step_matches_jax_at_bf16(case, monkeypatch):
    """One train step of ``case`` at bfloat16 against JAX's (``M_N`` 0.5,
    the case's global step): the capacity of BetaVAE B in float32, the
    MMD's prior and ``z`` in float32."""
    assert_zoo_step(_train_step_pair(
        monkeypatch, _pair(case), "base", CASES[case][0], exp=EXP,
        b={"image": _images(11)}, M_N=M_N, step=CASES[case][1],
        heads=True), EXP["LR"])


def test_wae_fc_z_computes_in_bf16_and_returns_f32():
    """WAE_MMD's ``fc_z`` is a layer of ``ops/layers.py``: it computes in
    bfloat16 (its float32 weight cast), and ``encode``'s ``z`` is its
    output widened to float32, as JAX's ``upcast32``."""
    _, _, tm = _pair("WAE_MMD-imq")
    assert tm.fc_z.compute_dtype == torch.bfloat16
    assert tm.fc_z.weight.dtype == torch.float32
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        feat = tm.encoder(x, train=False)
        z = tm.encode(x)[0]
        raw = tm.fc_z(feat.reshape(feat.shape[0], -1))
    assert raw.dtype == torch.bfloat16 and z.dtype == torch.float32
    assert torch.equal(z, raw.float())
    assert np.isfinite(z.numpy()).all()
