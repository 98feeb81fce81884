"""The port's optimizers (ctvae_torch/training/optimizers.py) against the
JAX package's optax chains (ctvae_tpu/training/optimizers.py), fed the
same gradients step after step.

Each case runs 8 calls on a toy parameter tree with a ``ct_layer`` and an
``encoder`` subtree, crossing an epoch boundary of the LR schedule.
Tolerance: atol 1e-6 (1e-4 of the largest LR) / rtol 1e-5 on the
parameters: f32 Adam on both sides, but torch and optax round the bias
corrections and the clip factor in another order, and Adam's first steps
divide a gradient by its own magnitude.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ctvae_tpu.training import optimizers as jopt
from ctvae_torch.training import optimizers as topt

SHAPES = {"ct_layer": {"b": (4,), "w": (3, 4)}, "encoder": {"w": (2, 3)}}
STEPS, SPE = 8, 4

CASES = {
    "decay": dict(LR=5e-4, scheduler_gamma=0.994),
    "gamma0": dict(LR=5e-4, scheduler_gamma=0.0),
    "clip_wd": dict(LR=1e-2, scheduler_gamma=0.9, gradient_clip_val=0.05,
                    weight_decay=1e-2),
    "accumulate": dict(LR=1e-2, scheduler_gamma=0.5,
                       accumulate_grad_batches=2),
    "ct_layer": dict(LR=5e-4, scheduler_gamma=0.994,
                     update_parameters="ct_layer", gradient_clip_val=0.5),
}


class _Sub(nn.Module):
    def __init__(self, shapes, rng):
        super().__init__()
        for k, shp in shapes.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(
                rng.normal(size=shp).astype(np.float32))))


class _Toy(nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.ct_layer = _Sub(SHAPES["ct_layer"], rng)
        self.encoder = _Sub(SHAPES["encoder"], rng)


def _tree(model):
    return {m: {k: jnp.asarray(getattr(getattr(model, m), k).detach().numpy())
                for k in SHAPES[m]} for m in SHAPES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    exp = CASES[case]
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    params = _tree(model)
    tx = jopt.build_optimizers(exp, params, SPE)[0]
    opt_state = tx.init(params)
    opt = topt.build_optimizers(exp, model, SPE)[0]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for step in range(STEPS):
        grads = {m: {k: rng.normal(scale=0.3, size=shp).astype(np.float32)
                     for k, shp in SHAPES[m].items()} for m in SHAPES}
        updates, opt_state = tx.update(
            {m: {k: jnp.asarray(v) for k, v in g.items()}
             for m, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            m, k = name.split(".")
            p.grad = torch.from_numpy(grads[m][k])
        opt.step()
        for name, p in model.named_parameters():
            m, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[m][k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{case} step {step} {name}")
    for name, p in model.named_parameters():
        frozen = (exp.get("update_parameters") is not None
                  and not name.startswith(exp["update_parameters"]))
        assert torch.equal(p.detach(), start[name]) == frozen, name
    if exp.get("update_parameters"):
        # the frozen subtree has no Adam state
        assert len(opt.adam.state) == len(SHAPES["ct_layer"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_lr_schedules_match_jax(case):
    exp = CASES[case]
    want = jopt.build_lr_schedules(exp, SPE)[0]
    got = topt.build_lr_schedules(exp, SPE)[0]
    for step in range(3 * SPE):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=f"{case} step {step}")
    if exp["scheduler_gamma"] == 0.0:
        assert got(SPE) == 0.0 and got(0) == exp["LR"]


def test_adversarial_optimizers_not_ported():
    model = _Toy(np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizers({"LR": 1e-3, "LR_2": 1e-3,
                               "submodel": "encoder"}, model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_lr_schedules({"LR": 1e-3, "LR_2": 1e-3})
    with pytest.raises(ValueError):
        topt.build_optimizers({"update_parameters": "decoder"}, model)
