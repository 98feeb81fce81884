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


def test_adversarial_optimizers_match_jax():
    """``LR_2`` + ``submodel`` (FactorVAE's protocol): ``build_optimizers``
    returns optimizer 0 over every parameter (JAX's first transform is
    unmasked) and optimizer 1, Adam(LR_2) with weight decay 0 (where the
    first has 1e-2) and the same clip, over the ``submodel`` subtree
    only; fed the same gradients step after step, each moves exactly the
    parameters JAX's transform of the same index moves, to JAX's values;
    ``build_lr_schedules`` gives both schedules (``scheduler_gamma_2``).
    ``update_parameters`` naming no parameter raises ValueError, as
    before."""
    exp = dict(LR=1e-2, LR_2=4e-3, scheduler_gamma=0.9,
               scheduler_gamma_2=0.5, weight_decay=1e-2,
               gradient_clip_val=0.5, submodel="encoder")
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    params = _tree(model)
    txs = jopt.build_optimizers(exp, params, SPE)
    opt_states = [tx.init(params) for tx in txs]
    opts = topt.build_optimizers(exp, model, SPE)
    assert len(opts) == len(txs) == 2
    names = {id(p): n for n, p in model.named_parameters()}
    assert [sorted(names[id(p)] for p in o.params) for o in opts] == [
        sorted(names.values()), ["encoder.w"]]
    assert [o.adam.param_groups[0]["weight_decay"] for o in opts] == [
        1e-2, 0.0]
    assert [o.clip for o in opts] == [0.5, 0.5]
    for step in range(STEPS):
        i = step % 2
        grads = {m: {k: rng.normal(scale=0.3, size=shp).astype(np.float32)
                     for k, shp in SHAPES[m].items()} for m in SHAPES}
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        updates, opt_states[i] = txs[i].update(
            {m: {k: jnp.asarray(v) for k, v in g.items()}
             for m, g in grads.items()}, opt_states[i], params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            m, k = name.split(".")
            p.grad = torch.from_numpy(grads[m][k])
        opts[i].step()
        for name, p in model.named_parameters():
            m, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[m][k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"opt {i} step {step} {name}")
            assert torch.equal(p.detach(), before[name]) == (
                i == 1 and not name.startswith("encoder")), name
    want = jopt.build_lr_schedules(exp, SPE)
    got = topt.build_lr_schedules(exp, SPE)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for step in range(3 * SPE):
            np.testing.assert_allclose(g(step), float(w(step)), rtol=1e-6)
    with pytest.raises(ValueError):
        topt.build_optimizers({"update_parameters": "decoder"}, model)
