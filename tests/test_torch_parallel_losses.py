"""The losses that are not a mean of per-row terms, under data parallelism
on the CPU: each of the nine configurations that pair, sort or take a
non-linear function of batch means (``configs/wae_mmd_imq.yaml``,
``wae_mmd_rbf``, ``infovae``, ``betatc_vae``, ``dip_vae``, ``swae``,
``mssim_vae``, ``joint_vae``, ``bbvae``: their loss settings and
exp_params as written, widths cut to img 16 (MSSIMVAE 32), hidden_dims
[8, 16] ([8, 8] for BetaTCVAE) and latent 8), one train step at global
step 3 and ``M_N`` = the config's ``kld_weight`` on a global batch of 4
rows, 2 on each of two gloo ranks (``tests/torch_dp_ranks.py``).

The JAX step runs on the global batch with its draws recorded; the ranks
replay them (each its rows of every draw of the global batch: the MMD's
prior and SWAE's projections at the global shape), and so does the port
in one process on the global batch. Tolerances: ranks against one
process each loss term and ``grad_norm`` within 1e-5 (atol and rtol),
each gradient within 1e-5 of its block's largest magnitude (a conv bias
before a BatchNorm has a gradient of rounding noise), each parameter
within 1e-5 plus Adam's reach of the gradients' difference
(``lr / 1e-8`` times it), each buffer within 1e-5; against JAX the
tolerances of ``tests/test_torch_zoo.py`` (losses atol 1e-6 / rtol
1e-4, gradients 1e-5 of the block's largest, JAX's raw gradients times
InfoVAE's clip coefficient against the port's clipped ones, parameters
within 2e-6
plus Adam's reach, BatchNorm's running statistics atol 1e-5 / rtol
1e-4); between the ranks bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ctvae_torch.convert import from_jax_params
from test_torch_parallel import finish, start
from test_torch_zoo import _assert_step_matches, _block
from torch_dp_ranks import run_steps
from torch_port_common import close, jax_train_step_state, one_torch_thread, \
    t2n

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ROWS = 2, 2                  # ranks, rows per rank
STEP = 3                            # the global step of the train step
TOL = 1e-5                          # ranks against one process
WIDTHS = dict(latent_dim=8, hidden_dims=[8, 16], img_size=16)
#: config -> its widths where they differ from WIDTHS
YAMLS = {"wae_mmd_imq": {}, "wae_mmd_rbf": {}, "infovae": {},
         "betatc_vae": {"hidden_dims": [8, 8]}, "dip_vae": {},
         "swae": {}, "mssim_vae": {"img_size": 32}, "joint_vae": {},
         "bbvae": {}}


def _config(name: str):
    """(model_params, exp_params, M_N) of ``configs/<name>.yaml`` with
    the widths cut and the trainer's ``gradient_clip_val`` moved in, as
    ``run.train`` moves it."""
    with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    mp = dict(cfg["model_params"], **{**WIDTHS, **YAMLS[name]})
    exp = dict(cfg["exp_params"])
    if "gradient_clip_val" in cfg.get("trainer_params", {}):
        exp["gradient_clip_val"] = cfg["trainer_params"]["gradient_clip_val"]
    return mp, exp, float(exp.get("kld_weight", 1.0))


def _pair(cfg):
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    jm = jax_build(dict(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    s = cfg["img_size"]
    x = np.random.default_rng(0).uniform(size=(2, s, s, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        dict(zip(("params", "reparam", "gumbel", "noise", "dropout"), keys)),
        jnp.asarray(x)))
    tm = build_model(dict(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    return jm, variables, tm


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Per config: the JAX step on the global batch (draws recorded), the
    port's step in one process and on each of two ranks with those draws
    replayed; and ``all_mean`` of values equal on both ranks."""
    mp = pytest.MonkeyPatch()
    jax_ref, specs = {}, {}
    try:
        for i, name in enumerate(YAMLS):
            cfg, exp, m_n = _config(name)
            jm, variables, tm = _pair(cfg)
            s = cfg["img_size"]
            b = {"image": np.random.default_rng(30 + i).uniform(
                size=(WORLD * ROWS, s, s, 3)).astype(np.float32)}
            j = jax_train_step_state(
                jm, variables, "base",
                {k: jnp.asarray(v) for k, v in b.items()}, mp, seed=40 + i,
                exp=exp, M_N=m_n, step=STEP)
            jax_ref[name] = j
            specs[name] = {"cfg": cfg, "exp": exp,
                           "state_dict": copy.deepcopy(tm.state_dict()),
                           "runs": [{"step": STEP, "M_N": m_n,
                                     "steps": [("base", b, j[3])]}]}
    finally:
        mp.undo()
    equal = torch.from_numpy(np.random.default_rng(3).normal(
        size=(5,)).astype(np.float32))
    ranks = start("steps", {"models": specs, "equal_values": equal},
                  tmp_path_factory.mktemp("dp_losses"))
    single = {name: run_steps(spec)[0] for name, spec in specs.items()}
    ranks = finish(ranks)
    return {"jax": jax_ref, "single": single, "ranks": ranks,
            "specs": specs, "equal": equal}


def _model(spec):
    from ctvae_torch.models import build_model
    tm = build_model(dict(spec["cfg"]), device="cpu")
    tm.load_state_dict(spec["state_dict"])
    return tm


@pytest.mark.parametrize("name", list(YAMLS))
def test_two_ranks_equal_one_process_on_the_global_batch(results, name):
    """Each rank's loss terms, ``grad_norm``, gradients, parameters after
    Adam and buffers against the port's one process on the global batch
    with the same draws; the two ranks bit-identical."""
    want = results["single"][name]
    lr = results["specs"][name]["exp"]["LR"]
    r0, r1 = (r[name][0] for r in results["ranks"])
    for part in ("params", "buffers"):
        for n, t in r0[part].items():
            assert torch.equal(t, r1[part][n]), (part, n)
    got = r0
    m_got, m_want = got["metrics"][0], want["metrics"][0]
    assert set(m_got) == set(m_want)
    for k, v in m_want.items():
        close(t2n(m_got[k]), t2n(v), atol=TOL, rtol=TOL)
    g_got, g_want = got["grads"][0], want["grads"][0]
    assert set(g_got) == set(g_want)
    scale = {}
    for n, g in g_want.items():
        scale[_block(n)] = max(scale.get(_block(n), 1.0),
                               float(g.abs().max()))
    for n, g in g_want.items():
        close(t2n(g_got[n]), t2n(g), atol=TOL * scale[_block(n)], rtol=0)
        tol = TOL + lr / 1e-8 * (g_got[n] - g).abs()
        assert bool(((got["params"][n] - want["params"][n]).abs()
                     <= tol).all()), n
    for n, t in want["buffers"].items():
        close(t2n(got["buffers"][n]), t2n(t), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(YAMLS))
def test_two_ranks_match_jax_on_the_global_batch(results, name):
    """Each rank's loss terms and ``grad_norm``, every gradient and every
    parameter after Adam, and BatchNorm's running statistics against the
    JAX step on the global batch."""
    j_params, j_grads, j_metrics, _, j_state = results["jax"][name]
    spec = results["specs"][name]
    clip = spec["exp"].get("gradient_clip_val")
    if clip:
        # the port's gradients are the clipped ones (clip_grad_norm_ in
        # place), JAX's the raw: scale JAX's by the clip's coefficient
        coef = min(1.0, clip / (float(j_metrics["grad_norm"]) + 1e-6))
        j_grads = jax.tree_util.tree_map(lambda g: g * coef, j_grads)
    tm = _model(spec)
    for r in results["ranks"]:
        got = r[name][0]
        metrics = got["metrics"][0]
        assert set(metrics) == set(j_metrics)
        for k, v in j_metrics.items():
            close(t2n(metrics[k]), v, atol=1e-6, rtol=1e-4)
        with torch.no_grad():
            for n, p in tm.named_parameters():
                p.copy_(got["params"][n])
                p.grad = got["grads"][0].get(n)
        _assert_step_matches(tm, j_params, j_grads, spec["exp"]["LR"])
        if j_state:
            want = from_jax_params({"params": j_params, **j_state}, tm)
            for n, t in got["buffers"].items():
                close(t2n(t), want[n].numpy(), atol=1e-5, rtol=1e-4)


def test_all_mean_leaves_equal_values_as_they_are(results):
    """The step's scalars that are already the global batch's (the MMD,
    the capacity terms) are equal on both ranks, and ``all_mean`` of
    values equal on every rank gives them back bit for bit."""
    for r in results["ranks"]:
        assert torch.equal(r["equal_values"], results["equal"])
    for name in YAMLS:
        r0, r1 = (r[name][0]["metrics"][0] for r in results["ranks"])
        for k, v in r0.items():
            assert torch.equal(v, r1[k]), (name, k)
