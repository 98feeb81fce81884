"""Fully sharded data parallelism of the port (``exp_params.sharding:
fsdp``, ``ctvae_torch/parallel/fsdp.py``) on the CPU: gloo ranks, each
its own process (``tests/torch_dp_ranks.py``, which imports nothing of
JAX), against the port's single process on the global batch, against
data-parallel ranks and against the JAX package's FSDP step.

- The plan (``fsdp_plan``) against ``ctvae_tpu.parallel.mesh.
  fsdp_shardings`` on a JAX mesh of 2 data devices and of 2 replicas x 2
  data, over the small CT-MCQ-VAE and a VQVAE with the YAML's codebook
  (512 x 64): the same leaves split, along the same axis of the JAX leaf,
  and nothing over ``replica``.
- The small CT model (``fsdp_min_size`` 64, so most leaves split), 3
  generator-drawn steps per mode at two ranks (2 rows each of a global
  batch of 4) against one process and against DP ranks; one step per
  mode with the JAX FSDP step's draws (a 2-device data mesh) replayed
  against that step; the Adam moments of the slices; a clip that bites
  (global norm); VQVAE's EMA codebook with revival; ``fit``, a resume and
  checkpoints moved between FSDP, DP and one process; one step per mode
  at a world of 4 with ``dcn_replicas: 2``.

Tolerances: against one process and DP ranks each loss, metric and
``grad_norm`` within 1e-5 (atol and rtol), each gradient within 1e-5 of
its leaf's scale, each buffer within 1e-5, each parameter within the
steps' count times 1e-5 plus LR / 1e-8 times the sum of its gradients'
differences (Adam moves a parameter by LR g / (|g| + 1e-8)); against JAX
those of ``tests/test_torch_parallel.py``; between the ranks, a resume
and the checkpoints' round trips bit for bit.
"""

import copy
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import _convert_leaf
from test_torch_parallel import (EXP, FIT, MODES, RANK_TIMEOUT, REPO, ROWS,
                                 WORLD, YAML, _env, _free_port,
                                 _global_batch, build_pair_model, finish,
                                 start)
from torch_dp_ranks import run_steps
from torch_port_common import (SMALL, assert_step_matches, batch, build_pair,
                               close, keep_grads, one_torch_thread,
                               recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MIN_SIZE = 64                       # fsdp_min_size of the runs
TOL = 1e-5
STEPS = 3                           # generator-drawn steps per mode
VQ = dict(name="VQVAE", in_channels=3, embedding_dim=64, num_embeddings=512,
          hidden_dims=[8, 16], img_size=16)
# decay 0.9 and threshold 0.5: the revival re-seeds some codes each step
VQ_EMA = dict(name="VQVAE", in_channels=3, embedding_dim=8,
              num_embeddings=16, hidden_dims=[8, 16], img_size=16, ema=True,
              ema_decay=0.9, revive_threshold=0.5)
CLIP = 0.05                         # below every step's grad_norm


# --- the plan ------------------------------------------------------------------

def _jax_params(cfg):
    """The JAX model's params (shapes from ``eval_shape``, zeros) and the
    port's model of ``cfg``."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    jm = jax_build(dict(cfg))
    s = cfg["img_size"]
    x = jnp.zeros((2, s, s, 3))
    kwargs = {}
    if cfg["name"] == "CTMCQVAE":
        kwargs = dict(mode="action", input_y=x,
                      action=jnp.zeros((2, cfg["action_dim"])))
    shapes = jax.eval_shape(lambda r: jm.init(r, x, **kwargs), dict(zip(
        ("params", "reparam", "gumbel", "noise", "dropout"),
        jax.random.split(jax.random.PRNGKey(0), 5))))["params"]
    params = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes)
    return params, build_model(dict(cfg), device="cpu")


def _jax_mesh(kind):
    from ctvae_tpu.parallel.mesh import make_hybrid_mesh, make_mesh
    devices = jax.devices()
    if kind == "data2":
        return make_mesh(devices[:2])
    return make_hybrid_mesh(2, devices=devices[:4])


@pytest.mark.parametrize("min_size", [MIN_SIZE, 1 << 12])
@pytest.mark.parametrize("mesh", ["data2", "hybrid2x2"])
@pytest.mark.parametrize("model", ["ct", "vqvae"])
def test_plan_splits_the_leaves_jax_splits(model, mesh, min_size):
    """Every JAX leaf that ``fsdp_shardings`` splits over ``data`` is
    split by ``fsdp_plan`` at the mesh's data size, along the port's dim
    that its axis converts to (a leaf of the axis' index, converted by
    ``convert.py``, varies along that dim alone); every other leaf is
    replicated; no leaf is split over ``replica``."""
    from ctvae_torch.parallel import fsdp_plan
    from ctvae_tpu.parallel.mesh import (DATA_AXIS, REPLICA_AXIS,
                                         fsdp_shardings)
    params, tm = _jax_params(SMALL if model == "ct" else VQ)
    jmesh = _jax_mesh(mesh)
    shardings = fsdp_shardings(params, jmesh, min_size=min_size)
    plan = fsdp_plan(tm, jmesh.shape[DATA_AXIS], min_size)
    modules = dict(tm.named_modules())
    want = {}
    for (path, sh), (_, leaf) in zip(
            jax.tree_util.tree_flatten_with_path(shardings)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        assert REPLICA_AXIS not in spec, (path, spec)
        keys = tuple(str(p.key) for p in path)
        axis = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        marker = np.zeros(leaf.shape, np.float32)
        if axis is not None:
            marker += np.arange(leaf.shape[axis]).reshape(
                [-1 if a == axis else 1 for a in range(leaf.ndim)])
        name, conv = _convert_leaf(keys, marker, modules)
        dims = [d for d in range(conv.ndim)
                if np.ptp(conv, axis=d).max() > 0]
        # (model dim, data dim): no model axis on these meshes
        want[name] = (None, dims[0]) if axis is not None else None
        assert axis is None or len(dims) == 1, (name, dims)
    assert want == plan
    if min_size == MIN_SIZE:        # the convs and MLP weights qualify
        assert sum(a is not None for a in plan.values()) >= 10


# --- train steps ---------------------------------------------------------------

def _jax_fsdp_step(jm, variables, mode, b, mp, seed, exp):
    """One JAX train step with ``fsdp_shardings`` over a mesh of 2 data
    devices (``pin_state_shardings``), on the global batch split over
    them, its draws recorded: (params, raw gradients, metrics, draws)."""
    import optax

    from ctvae_tpu.parallel.mesh import (make_mesh, pin_state_shardings,
                                         put_replicated, shard_batch,
                                         shard_params_fsdp)
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    mesh = make_mesh(jax.devices()[:WORLD])
    params = variables["params"]
    tx = optax.chain(keep_grads(), jopt.build_optimizers(exp, params, 4)[0])
    with mesh:
        sp = shard_params_fsdp(params, mesh, min_size=MIN_SIZE)
        state = jstate.TrainState(
            step=put_replicated(jnp.array(0, jnp.int32), mesh), params=sp,
            model_state=put_replicated(
                {k: v for k, v in variables.items() if k != "params"}, mesh),
            opt_states=(tx.init(sp),),
            rng=put_replicated(jax.random.PRNGKey(seed), mesh))
        fn = pin_state_shardings(jstate.make_train_step(
            jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
            static_fwd_kwargs={"mode": mode}), state)
        with recorded_draws(mp, seed=seed) as rec:
            new, metrics = jax.jit(fn)(state, shard_batch(b, mesh))
        split = sum(not leaf.sharding.is_fully_replicated
                    for leaf in jax.tree_util.tree_leaves(new.params))
    return (jax.device_get(new.params), jax.device_get(new.opt_states[0][0]),
            jax.device_get(metrics), rec.draws, split)


def _runs(name_seed, n_steps, modes, seed0=7):
    return [{"seed": seed0 + i, "steps": [
        (mode, _global_batch("ct", name_seed + 3 * i + k), None)
        for k in range(n_steps)]} for i, mode in enumerate(modes)]


def _vq_batch(seed, rows=WORLD * ROWS):
    return {"image": np.random.default_rng(seed).uniform(
        size=(rows, 16, 16, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The ranks of the loop and of the world of 4, started first: they
    run while the JAX references compile."""
    fit_tmp = tmp_path_factory.mktemp("fsdp_fit")
    _, _, tm = build_pair(SMALL, seed=0)
    hybrid = {"cfg": SMALL, "exp": EXP, "fsdp": MIN_SIZE,
              "dcn_replicas": 2,
              "state_dict": copy.deepcopy(tm.state_dict()),
              "runs": [{"seed": 21 + i, "steps": [(mode, dict(zip(
                  ("image", "input_y", "action"),
                  batch(81 + i, B=4 * ROWS))), None)]}
                  for i, mode in enumerate(MODES)]}
    b = _global_batch("ct", 61)
    fit = dict(FIT, root=str(fit_tmp), fsdp=MIN_SIZE,
               batch={k: v[:ROWS] for k, v in b.items()})
    return {"fit": start("fsdp_fit", fit, fit_tmp),
            "hybrid": (start("steps", {"models": {"ct": hybrid}},
                             tmp_path_factory.mktemp("fsdp_hybrid"), world=4),
                       hybrid)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, background):
    """The generator-drawn runs (FSDP, DP, FSDP with a clip, VQVAE's EMA
    codebook under FSDP) on two ranks and in one process; the JAX FSDP
    step of each mode with its draws replayed on two FSDP ranks."""
    jm, variables, tm = build_pair(SMALL, seed=0)
    sd = copy.deepcopy(tm.state_dict())
    from ctvae_torch.models import build_model
    vq = build_model(dict(VQ_EMA), device="cpu",
                     generator=torch.Generator().manual_seed(3))
    base = {"cfg": SMALL, "exp": EXP, "state_dict": sd}
    gen = {"ct_fsdp": {**base, "fsdp": MIN_SIZE,
                       "runs": _runs(51, STEPS, MODES)},
           "ct_dp": {**base, "runs": _runs(51, STEPS, MODES)},
           # every leaf below the threshold: nothing split
           "ct_fsdp_none": {**base, "fsdp": 1 << 30,
                            "runs": _runs(51, STEPS, MODES)},
           "ct_clip": {**base, "fsdp": MIN_SIZE,
                       "exp": dict(EXP, gradient_clip_val=CLIP),
                       "runs": [dict(r, watch=True)
                                for r in _runs(71, 1, MODES)]},
           "vq_ema": {"cfg": VQ_EMA, "exp": EXP, "fsdp": MIN_SIZE,
                      "state_dict": copy.deepcopy(vq.state_dict()),
                      "runs": [{"seed": 5, "steps": [
                          ("base", _vq_batch(90 + k), None)
                          for k in range(2)]}]}}
    gen_ranks = start("steps", {"models": gen},
                      tmp_path_factory.mktemp("fsdp_gen"))
    mp = pytest.MonkeyPatch()
    jax_ref, runs = {}, []
    try:
        for i, mode in enumerate(MODES):
            b = _global_batch("ct", 31 + i)
            j = _jax_fsdp_step(jm, variables, mode,
                               {k: jnp.asarray(v) for k, v in b.items()}, mp,
                               seed=41 + i, exp=EXP)
            jax_ref[mode] = j
            runs.append({"steps": [(mode, b, j[3])]})
    finally:
        mp.undo()
    replay = {"ct_jax": {**base, "fsdp": MIN_SIZE, "runs": runs}}
    replay_ranks = start("steps", {"models": replay},
                         tmp_path_factory.mktemp("fsdp_replay"))
    single = {name: run_steps(spec) for name, spec in gen.items()
              if name in ("ct_fsdp", "ct_clip", "vq_ema")}
    gen_ranks, replay_ranks = finish(gen_ranks), finish(replay_ranks)
    ranks = [{**g, **r} for g, r in zip(gen_ranks, replay_ranks)]
    return {"jax": jax_ref, "single": single, "ranks": ranks, "base": base}


def _assert_runs_match(got, want, lr, n_steps):
    """A run on a rank against another run of the same steps (metrics,
    gradients, parameters within Adam's reach, buffers)."""
    assert got["step"] == want["step"]
    for m_got, m_want in zip(got["metrics"], want["metrics"]):
        assert set(m_got) == set(m_want)
        for key in m_want:
            close(t2n(m_got[key]), t2n(m_want[key]), atol=TOL, rtol=TOL)
    diff = {n: torch.zeros_like(p) for n, p in want["params"].items()}
    for g_got, g_want in zip(got["grads"], want["grads"]):
        assert set(g_got) == set(g_want)
        for n, g in g_want.items():
            scale = max(1.0, float(g.abs().max()))
            close(t2n(g_got[n]), t2n(g), atol=TOL * scale, rtol=0)
            diff[n] += (g_got[n] - g).abs()
    assert set(got["params"]) == set(want["params"])
    for n, p in want["params"].items():
        assert got["params"][n].shape == p.shape, n
        tol = n_steps * (TOL + lr / 1e-8 * diff[n])
        assert bool(((got["params"][n] - p).abs() <= tol).all()), n
    for n, t in want["buffers"].items():
        close(t2n(got["buffers"][n]), t2n(t), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_fsdp_steps_equal_one_process_on_the_global_batch(steps, mode):
    """Each FSDP rank's generator-drawn steps of ``mode``: metrics,
    ``grad_norm``, the gathered gradients, parameters and buffers against
    one process on the global batches."""
    k = MODES.index(mode)
    for r in steps["ranks"]:
        got = r["ct_fsdp"][k]
        assert got["axes"], "nothing was split"
        _assert_runs_match(got, steps["single"]["ct_fsdp"][k], EXP["LR"],
                           STEPS)


@pytest.mark.parametrize("mode", MODES)
def test_fsdp_steps_equal_dp_ranks(steps, mode):
    """The same steps under FSDP and under plain DP ranks agree."""
    k = MODES.index(mode)
    for r in steps["ranks"]:
        _assert_runs_match(r["ct_fsdp"][k], r["ct_dp"][k], EXP["LR"], STEPS)


@pytest.mark.parametrize("mode", MODES)
def test_fsdp_step_matches_the_jax_fsdp_step(steps, mode):
    """One step of ``mode`` with the JAX FSDP step's draws replayed (each
    rank its rows): metrics, ``grad_norm``, the gathered gradients and the
    parameters after Adam against the JAX step, whose updated parameters
    kept their split layout."""
    j_params, j_grads, j_metrics, _, split = steps["jax"][mode]
    assert split > 10
    tm = build_pair_model(steps["base"])
    for r in steps["ranks"]:
        got = r["ct_jax"][MODES.index(mode)]
        metrics = got["metrics"][0]
        assert set(metrics) == set(j_metrics)
        for key, v in j_metrics.items():
            close(t2n(metrics[key]), v, atol=1e-5, rtol=1e-4)
        close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
              rtol=1e-5)
        with torch.no_grad():
            for n, p in tm.named_parameters():
                p.copy_(got["params"][n])
                p.grad = got["grads"][0].get(n)
        assert_step_matches(tm, j_params, j_grads, EXP["LR"])


@pytest.mark.parametrize("mode", MODES)
def test_fsdp_with_nothing_split_is_dp_bit_for_bit(steps, mode):
    """Under FSDP with every leaf below ``fsdp_min_size`` (as at a data
    size of 1, where JAX splits nothing) the steps are the DP ranks' bit
    for bit: metrics (``grad_norm`` summed in the same order), gradients,
    parameters, buffers."""
    k = MODES.index(mode)
    for r in steps["ranks"]:
        got, want = r["ct_fsdp_none"][k], r["ct_dp"][k]
        assert not got["axes"]
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            for key, v in m_want.items():
                assert torch.equal(m_got[key], v), key
        for g_got, g_want in zip(got["grads"], want["grads"]):
            for n, g in g_want.items():
                assert torch.equal(g_got[n], g), n
        for part in ("params", "buffers"):
            for n, t in want[part].items():
                assert torch.equal(got[part][n], t), (part, n)


def test_fsdp_ranks_hold_their_slices_and_end_bit_identical(steps):
    """The two ranks' gathered parameters and buffers are equal bit for
    bit; each holds the half of every split leaf along its planned dim
    (rank 0 the first), and the halves make the full parameter."""
    r0, r1 = (r["ct_fsdp"] for r in steps["ranks"])
    for a, b in zip(r0, r1):
        for part in ("params", "buffers"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (part, n)
        for n, axis in a["axes"].items():
            full = a["params"][n]
            assert torch.equal(torch.cat([a["slices"][n], b["slices"][n]],
                                         dim=axis), full), n


def test_adam_moments_hold_only_the_slice(steps):
    """Each split parameter's Adam moments have its slice's shape (half
    the full one along the planned dim); the bytes of parameters and
    moments resident between steps are DP's less half of each split
    leaf's and of its moments'."""
    for r in steps["ranks"]:
        for got, dp in zip(r["ct_fsdp"], r["ct_dp"]):
            full = {n: tuple(p.shape) for n, p in got["params"].items()}
            for n, shape in got["moments"][0].items():
                want = list(full[n])
                if n in got["axes"]:
                    want[got["axes"][n]] //= 2
                assert shape == tuple(want), n
            # half of each split parameter, and of its two moments where
            # Adam holds them (a parameter that got no gradient has none)
            saved = sum(got["params"][n].numel() * 4 // 2
                        * (3 if n in got["moments"][0] else 1)
                        for n in got["axes"])
            assert got["resident_bytes"] == dp["resident_bytes"] - saved


def test_grad_norm_and_the_clip_are_global(steps):
    """With ``gradient_clip_val`` below the step's gradient norm, the
    FSDP ranks' ``grad_norm``, the per-module norms of
    ``watch_gradients`` (``grad_norm/<module>`` before the clip,
    ``param_norm/<module>`` after the update) and the clipped update are
    one process's: the norms sum the slices' squares over the ranks."""
    for r in steps["ranks"]:
        for got, want in zip(r["ct_clip"], steps["single"]["ct_clip"]):
            assert float(want["metrics"][0]["grad_norm"]) > 2 * CLIP
            assert {"grad_norm/ct_layer", "param_norm/encoder"} <= set(
                got["metrics"][0])
            _assert_runs_match(got, want, EXP["LR"], 1)


def test_ema_codebook_with_revival_under_fsdp(steps):
    """VQVAE's EMA codebook under FSDP (``fsdp_min_size`` 64): its
    buffers stay whole on every rank and equal one process's after two
    steps whose revival re-seeded codes; the convolutions are split."""
    want = steps["single"]["vq_ema"][0]
    for r in steps["ranks"]:
        got = r["vq_ema"][0]
        assert got["axes"] and not any("quantizer" in n or "embedding" in n
                                       for n in got["axes"])
        _assert_runs_match(got, want, EXP["LR"], 2)
        sizes = [t for n, t in got["buffers"].items()
                 if n.endswith("cluster_size")]
        assert sizes and all(bool((s == 1.0).any()) for s in sizes)
        for n, t in got["buffers"].items():
            assert t.shape == want["buffers"][n].shape, n


# --- the loop and checkpoints --------------------------------------------------

@pytest.fixture(scope="module")
def fit(background):
    return finish(background["fit"])


def test_fsdp_fit_writes_full_checkpoints_on_rank_0(fit):
    """Under ``sharding: fsdp`` rank 0 alone writes, the split leaves
    are some of the model's, and the file holds every parameter at its
    full shape."""
    assert fit[0]["saves"] and not fit[1]["saves"]
    assert fit[0]["split"] == fit[1]["split"] and fit[0]["split"]
    for n, t in fit[0]["after_1"].items():
        assert torch.equal(t, fit[1]["after_1"][n]), n


def test_fsdp_resume_continues_bit_for_bit(fit):
    """Every rank restores rank 0's ``last`` into its slices (equal to
    the state it saved) and trains the second epoch: the same state, bit
    for bit, as two epochs without a stop."""
    for res in fit:
        assert res["restored_equal"]
        assert res["resumed_step"] == res["straight_step"] > 0
        for n, t in res["straight"].items():
            assert torch.equal(res["resumed"][n], t), n


@pytest.mark.parametrize("src", ["fsdp", "dp", "single"])
@pytest.mark.parametrize("dst", ["fsdp", "dp", "single"])
def test_checkpoints_move_between_fsdp_dp_and_one_process(fit, src, dst):
    """A checkpoint of an FSDP run, of a DP run or of one process
    restored into FSDP ranks, DP ranks or one process: the state
    (parameters, both Adam moments, step counts, schedule position, step,
    generator) then equals the file's, bit for bit."""
    for res in fit:
        assert res["moves"][f"{src}-{dst}"] == []


# --- a world of 4 with dcn_replicas: 2 -----------------------------------------

@pytest.fixture(scope="module")
def hybrid(background):
    started, spec = background["hybrid"]
    return finish(started), spec


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_world_of_4_equals_one_process(hybrid, mode):
    """Four ranks, ``dcn_replicas: 2`` (2 replicas x 2 data), one step of
    ``mode`` on a global batch of 8: every rank against one process."""
    results, spec = hybrid
    k = MODES.index(mode)
    want = run_steps({**spec, "runs": [spec["runs"][k]]})[0]
    for r in results:
        _assert_runs_match(r["ct"][k], want, EXP["LR"], 1)


def test_hybrid_splits_nothing_over_replica(hybrid):
    """The slices are split over ``data`` alone: the ranks at one data
    index of the two replicas (0 and 2, 1 and 3) hold the same slices,
    the two data indices of a replica different halves."""
    results, _ = hybrid
    for k in range(len(MODES)):
        s = [r["ct"][k]["slices"] for r in results]
        assert s[0] and set(s[0]) == set(s[1])
        for n in s[0]:
            assert torch.equal(s[0][n], s[2][n]) and torch.equal(
                s[1][n], s[3][n]), n
        assert any(not torch.equal(s[0][n], s[1][n]) for n in s[0])


# --- torchrun ------------------------------------------------------------------

def test_torchrun_two_ranks_with_fsdp_on_the_cpu(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ctvae_torch.run --device cpu`` of a config with ``sharding: fsdp``
    and ``fsdp_min_size: 64``: both ranks exit 0, one epoch line, and the
    checkpoint holds every parameter at its full shape."""
    from ctvae_torch.models import build_model
    save_dir = tmp_path / "logs"
    cfg = tmp_path / "fsdp.yaml"
    cfg.write_text(YAML.replace(
        "manual_seed: 1265}}",
        "manual_seed: 1265, sharding: fsdp, fsdp_min_size: 64}}").format(
        save_dir=save_dir))
    log = str(tmp_path / "torchrun.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
             "--master_port", str(_free_port()), "-m", "ctvae_torch.run",
             "-c", str(cfg), "--device", "cpu"],
            env=_env(), cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        proc.wait(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    text = open(log).read()
    assert proc.returncode == 0, text
    assert text.count("epoch 0:") == 1, text
    blob = torch.load(save_dir / "CTMCQVAE" / "version_0" / "checkpoints" /
                      "last", weights_only=True)
    from ctvae_torch.config import read_config
    model = build_model(read_config(str(cfg))["model_params"], device="cpu")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert {n: tuple(t.shape) for n, t in blob["model"].items()} == shapes


# --- still refused -------------------------------------------------------------

@pytest.mark.parametrize("extra", [dict(sharding="sp"),
                                   dict(sharding="fsdp", model_axis=2)],
                         ids=["sp", "model_axis"])
def test_sequence_parallelism_and_a_model_axis_still_raise(extra):
    """In one process ``sharding: sp`` (a model axis of 2 by default) and
    ``sharding: fsdp`` with ``model_axis`` 2 (JAX's tensor-parallel
    rules, ported: tests/test_torch_fsdp_tp.py) have no world for two
    model ranks: the trainer takes the options and raises ``ValueError``
    at setup."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    model = build_model(dict(SMALL), device="cpu")
    exp = VAEXperiment(model, {**EXP, **extra}, None)
    with pytest.raises(ValueError, match="model_axis 2"):
        exp.setup()
