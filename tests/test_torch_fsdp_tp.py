"""Tensor-parallel FSDP (``exp_params.sharding: fsdp`` with ``model_axis``
> 1, ``ctvae_torch/parallel/fsdp.py``) and multi-step training over gloo
groups of more than one rank (``scan_steps`` > 1) on the CPU: gloo ranks,
each its own process (``tests/torch_dp_ranks.py``, which imports nothing
of JAX), against the port's single process on the global batch and
against the JAX package's FSDP step on a mesh with a ``model`` axis.

Under FSDP with a model axis the leaves that JAX's tensor-parallel rules
name (``DEFAULT_TP_RULES``: the discoverer's ``disc_w1l`` / ``disc_w1r``
on their hidden axis, ``disc_b1`` on axis 1, every codebook's
``embedding`` on its entries) are split over ``model``; inside that block
the largest free axis that the data size divides is split over ``data``,
as ``ctvae_tpu.parallel.mesh.fsdp_shardings`` does.

- (a) The plan (``fsdp_plan``) against ``fsdp_shardings`` spec for spec
  on the small CT model and a VQVAE at (data 1, model 2), (data 2,
  model 2) and (data 1, model 4); at a model size of 1 the data-only
  plan of FSDP without a model axis, entry for entry.
- (b) Two ranks at (data 1, model 2) and four at (data 2, model 2) and
  (data 1, model 4), three generator-drawn steps a mode, against one
  process on the global batch: losses within 1e-5 of 1 + |value|, every
  parameter's gradient within 1e-5 of its leaf's scale, parameters
  within Adam's reach (``test_torch_fsdp._assert_runs_match``).
- (c) One step a mode with the draws of JAX's FSDP step on a (data 1,
  model 2) CPU mesh replayed, against that step.
- (d) Each rank holds its block of every split leaf and of its Adam
  moments (the bytes resident between steps counted from the plan); the
  ranks end bit-identical; with a clip that bites, ``grad_norm``, the
  per-module norms and the clipped update are one process's.
- (e) ``fit`` under a model axis with a resume, bit for bit; checkpoints
  moved between FSDP with a model axis, FSDP, DP ranks and one process.
- (f) bfloat16 at (data 1, model 2), the causal step with JAX's draws and
  flip-prone decisions replayed: every gradient within twice JAX's
  bfloat16 distance to the port's float32 step
  (``test_torch_bf16_ranks._assert_matches_jax``).
- (g) ``scan_steps`` 2 and 4 over two gloo ranks under ``dp``, ``fsdp``
  with a model axis and ``sp``: one ``make_multi_train_step`` call runs
  its steps eagerly (no graph) into the state of K single steps bit for
  bit, and those against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import _convert_leaf
from test_torch_bf16 import Taps, _bf16
from test_torch_bf16_ranks import _assert_matches_jax, _f32
from test_torch_fsdp import MIN_SIZE, VQ, _assert_runs_match, _jax_params
from test_torch_parallel import (EXP, FIT, MODES, RANK_TIMEOUT, ROWS,
                                 _global_batch, finish, send, start)
from test_torch_sp import SP, _batch
from torch_dp_ranks import run_steps
from torch_port_common import (SMALL, assert_step_matches, close, keep_grads,
                               one_torch_thread, port_pair, recorded_draws,
                               t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 3                           # generator-drawn steps a mode
CLIP = 0.05                         # below every step's grad_norm
#: (data, model) sizes of the meshes, the world their product
MESHES = {"data1_model2": (1, 2), "data2_model2": (2, 2),
          "data1_model4": (1, 4)}
SCAN_KS = (2, 4)
SCAN_SHARDINGS = ("dp", "fsdp_tp", "sp")
CT_BF16 = _bf16(SMALL)


# --- (a) the plan ------------------------------------------------------------

def _jax_plan(params, jmesh, min_size, modules):
    """``fsdp_shardings``' spec of each JAX leaf as the port's
    ``(model dim, data dim)`` or None: each axis mapped through
    ``convert.py`` (a leaf of that axis' index, converted, varies along
    that dim alone)."""
    from ctvae_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, fsdp_shardings
    shardings = fsdp_shardings(params, jmesh, min_size=min_size)
    want = {}
    for (path, sh), (_, leaf) in zip(
            jax.tree_util.tree_flatten_with_path(shardings)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        keys = tuple(str(p.key) for p in path)
        split = []
        for axis_name in (MODEL_AXIS, DATA_AXIS):
            axis = spec.index(axis_name) if axis_name in spec else None
            marker = np.zeros(leaf.shape, np.float32)
            if axis is not None:
                marker += np.arange(leaf.shape[axis]).reshape(
                    [-1 if a == axis else 1 for a in range(leaf.ndim)])
            name, conv = _convert_leaf(keys, marker, modules)
            dims = [d for d in range(conv.ndim)
                    if np.ptp(conv, axis=d).max() > 0]
            assert axis is None or len(dims) == 1, (name, dims)
            split.append(dims[0] if axis is not None else None)
        want[name] = None if split == [None, None] else tuple(split)
    return want


@pytest.mark.parametrize("min_size", [MIN_SIZE, 1 << 12])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["ct", "vqvae"])
def test_tp_plan_is_jax_fsdp_shardings(model, mesh, min_size):
    """Every leaf's split over ``model`` and over ``data`` is the one
    ``fsdp_shardings`` gives it on a JAX mesh of the same sizes, along
    the port's dim its axis converts to; the ruled leaves are split over
    ``model`` (the CT model's discoverer and codebooks, VQVAE's
    codebook)."""
    from ctvae_torch.parallel import fsdp_plan
    from ctvae_tpu.parallel.mesh import make_mesh
    d, m = MESHES[mesh]
    params, tm = _jax_params(SMALL if model == "ct" else VQ)
    jmesh = make_mesh(jax.devices()[:d * m], model_axis=m)
    plan = fsdp_plan(tm, d, min_size, m)
    assert plan == _jax_plan(params, jmesh, min_size,
                             dict(tm.named_modules()))
    over_model = {n for n, s in plan.items() if s and s[0] is not None}
    if model == "ct":
        assert {"ct_layer.disc_w1l", "ct_layer.disc_w1r",
                "ct_layer.disc_b1"} <= over_model, over_model
    assert any(n.endswith("embedding") for n in over_model), over_model
    if d > 1 and min_size == MIN_SIZE:      # a leaf carries both splits
        assert any(s and None not in s for s in plan.values())


def _data_only_plan(model, data_size, min_size):
    """The plan of FSDP without a model axis as the port made it before
    the tensor-parallel rules: a parameter of at least ``min_size``
    elements split along the largest of its JAX leaf's axes that the data
    size divides."""
    from ctvae_torch.parallel.mesh import _jax_axes
    modules = dict(model.named_modules())
    plan = {}
    for name, p in model.named_parameters():
        plan[name] = None
        if data_size <= 1 or p.numel() < min_size:
            continue
        parent, _, leaf = name.rpartition(".")
        free = [a for a in _jax_axes(modules[parent], leaf, p.dim())
                if p.shape[a] % data_size == 0]
        if free:
            plan[name] = (None, max(free, key=lambda a: p.shape[a]))
    return plan


@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("model", ["ct", "vqvae"])
def test_plan_at_model_1_is_the_data_plan(model, data):
    """With a model size of 1 the rules claim nothing: the plan is the
    data-only plan entry for entry."""
    from ctvae_torch.parallel import fsdp_plan
    _, tm = _jax_params(SMALL if model == "ct" else VQ)
    assert fsdp_plan(tm, data, MIN_SIZE) == _data_only_plan(tm, data,
                                                            MIN_SIZE)


# --- the ranks ---------------------------------------------------------------

def _spec(cfg, state_dict, runs, mesh=(1, 2), fsdp=MIN_SIZE, **extra):
    spec = {"cfg": cfg, "exp": EXP, "state_dict": state_dict, "runs": runs,
            **extra}
    if mesh is not None:
        spec["mesh"] = mesh
    if fsdp is not None:
        spec["fsdp"] = fsdp
    return spec


def _gen_runs(seed, rows, n_steps=STEPS, **run):
    return [{"seed": 7 + i, **run, "steps": [
        (mode, _batch(seed + 3 * i + k, rows), None)
        for k in range(n_steps)]} for i, mode in enumerate(MODES)]


def _scan_specs(sd, sp_sd):
    """(g): per sharding, a run of K causal steps as one multi-step call
    and the same K steps one by one, for each K."""
    out = {}
    for kind in SCAN_SHARDINGS:
        rows = 2 * ROWS if kind == "dp" else ROWS
        runs = []
        for i, k in enumerate(SCAN_KS):
            steps = [("causal", _batch(201 + 10 * i + j, rows), None)
                     for j in range(k)]
            runs += [{"seed": 31 + i, "scan": True, "steps": steps},
                     {"seed": 31 + i, "steps": steps}]
        cfg, state = (SP, sp_sd) if kind == "sp" else (SMALL, sd)
        out[f"scan_{kind}"] = _spec(
            cfg, state, runs, mesh=None if kind == "dp" else (1, 2),
            fsdp=MIN_SIZE if kind == "fsdp_tp" else None)
    return out


def _jax_tp_step(jm, variables, mode, b, mp, seed):
    """JAX's FSDP train step on a (data 1, model 2) mesh of two CPU
    devices (``fsdp_shardings`` at ``MIN_SIZE`` with the tensor-parallel
    rules, ``pin_state_shardings``), traced here with its draws recorded;
    returns a function that compiles and runs it (on a thread) and
    returns (params, raw gradients, metrics, draws, model state, the
    dtypes of the leaves split over ``model``)."""
    import optax

    from ctvae_tpu.parallel.mesh import (MODEL_AXIS, make_mesh,
                                         pin_state_shardings, put_replicated,
                                         shard_batch, shard_params_fsdp)
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    mesh = make_mesh(jax.devices()[:2], model_axis=2)
    params = variables["params"]
    tx = optax.chain(keep_grads(), jopt.build_optimizers(EXP, params, 4)[0])
    with mesh:
        sharded = shard_params_fsdp(params, mesh, min_size=MIN_SIZE)
        state = jstate.TrainState(
            step=put_replicated(jnp.array(0, jnp.int32), mesh),
            params=sharded, model_state=put_replicated(
                {k: v for k, v in variables.items() if k != "params"}, mesh),
            opt_states=(tx.init(sharded),),
            rng=put_replicated(jax.random.PRNGKey(seed), mesh))
        fn = pin_state_shardings(jstate.make_train_step(
            jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
            static_fwd_kwargs={"mode": mode}), state)
        batch = shard_batch(b, mesh)
        with recorded_draws(mp, seed=seed) as rec:
            lowered = jax.jit(fn).lower(state, batch)

    def run():
        with mesh:
            new, metrics = lowered.compile()(state, batch)
        split = [leaf.dtype for leaf in jax.tree_util.tree_leaves(new.params)
                 if MODEL_AXIS in tuple(leaf.sharding.spec)]
        return (jax.device_get(new.params),
                jax.device_get(new.opt_states[0][0]),
                jax.device_get(metrics), rec.draws,
                jax.device_get(new.model_state), split)
    return run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawns of this module, started at once: two ranks (the
    generator-drawn steps at (data 1, model 2), a clip, the multi-step
    runs, the loop and checkpoints, then the replays of JAX's steps,
    whose payload they wait for) and four (the steps at (data 2, model
    2) and (data 1, model 4)), rank 0 of each then one process on the
    same global batches; meanwhile JAX's FSDP steps on a model axis are
    traced here, their draws sent to the two ranks, and compiled."""
    from concurrent.futures import ThreadPoolExecutor

    from ctvae_torch.models import build_model

    def init(cfg):
        return build_model(dict(cfg), device="cpu",
                           generator=torch.Generator().manual_seed(2)
                           ).state_dict()
    sd, sp_sd = init(SMALL), init(SP)
    gen = {"tp": _spec(SMALL, sd, _gen_runs(51, ROWS)),
           "clip": _spec(SMALL, sd, _gen_runs(71, ROWS, 1, watch=True),
                         exp=dict(EXP, gradient_clip_val=CLIP)),
           **_scan_specs(sd, sp_sd)}
    four = {name: _spec(SMALL, sd, _gen_runs(61, ROWS * d), mesh=(1, m))
            for name, (d, m) in MESHES.items() if d * m == 4}
    tmp = tmp_path_factory.mktemp("tp_ranks")
    b = _global_batch("ct", 61)
    fit = dict(FIT, root=str(tmp / "fit"), fsdp=MIN_SIZE,
               batch={k: v[:ROWS] for k, v in b.items()})

    def one_process(specs):
        # the per-step runs of each spec in one process on the global
        # batches
        return {name: {**spec, "runs": [r for r in spec["runs"]
                                        if not r.get("scan")]}
                for name, spec in specs.items()}
    spawns = {
        "two": start("fsdp_tp", {"gen": {"models": gen,
                                         "single": one_process(gen)},
                                 "fit": fit, "replay": str(tmp / "replay.pt")},
                     tmp),
        "four": start("steps", {"models": four, "single": one_process(four)},
                      tmp_path_factory.mktemp("tp_four"), world=4)}
    mp = pytest.MonkeyPatch()
    cases = [(SMALL, mode) for mode in MODES] + [(CT_BF16, "causal")]
    runs, batches, taps, pairs = {}, {}, {}, {}
    try:
        for i, (cfg, mode) in enumerate(cases):
            key = (cfg.get("dtype", "float32"), mode)
            pairs[key] = jm, variables, tm = port_pair(cfg, seed=1)
            batches[key] = _batch(31 + i, ROWS)
            with mp.context() as m:
                if key[0] == "bfloat16":
                    taps[key] = Taps(ordered=False)
                    taps[key].jax(m)
                runs[key] = _jax_tp_step(
                    jm, variables, mode,
                    {k: jnp.asarray(v) for k, v in batches[key].items()}, m,
                    seed=41 + i)
    finally:
        mp.undo()
    with ThreadPoolExecutor(len(runs)) as pool:
        jax_ref = dict(zip(runs, pool.map(lambda run: run(), runs.values())))
    # the runs recorded the draws and decisions: the ranks replay them
    bkey = ("bfloat16", "causal")
    bf_step = (bkey[1], batches[bkey], jax_ref[bkey][3],
               {k: list(v) for k, v in taps[bkey].rec.items()})
    replay = {
        "ct": _spec(SMALL, pairs["float32", "causal"][2].state_dict(), [
            {"steps": [(mode, batches["float32", mode],
                        jax_ref["float32", mode][3])]} for mode in MODES]),
        "bf16": _spec(CT_BF16, pairs[bkey][2].state_dict(),
                      [{"steps": [bf_step]}])}
    send(tmp / "replay.pt", {"models": replay})
    # the bfloat16 step in one process, and its float32 twin on the same
    # values, draws and decisions
    one = {**replay["bf16"], "fsdp": None, "mesh": None}
    single_bf16 = run_steps(one)
    twin = run_steps({**one, "cfg": SMALL,
                      "state_dict": _f32(one["state_dict"])})
    two = finish(spawns["two"], timeout=3 * RANK_TIMEOUT)
    four = finish(spawns["four"], timeout=3 * RANK_TIMEOUT)
    return {"jax": jax_ref, "specs": {"replay": replay, "gen": gen},
            "single": {**two[0]["single"], **four[0].pop("single")},
            "gen": [r["gen"] for r in two], "fit": [r["fit"] for r in two],
            "replay": [r["replay"] for r in two], "four": four,
            "single_bf16": single_bf16, "twin": twin}


# --- (b) against one process -------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_at_data1_model2_equal_one_process(ranks, mode):
    """(data 1, model 2): each rank's three steps of ``mode`` against one
    process on the global batches: losses and metrics, ``grad_norm``,
    every parameter's gradient, the parameters and buffers after them."""
    k = MODES.index(mode)
    for r in ranks["gen"]:
        got = r["tp"][k]
        assert any(s[0] is not None for s in got["plan"].values())
        _assert_runs_match(got, ranks["single"]["tp"][k], EXP["LR"], STEPS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", ["data2_model2", "data1_model4"])
def test_four_ranks_equal_one_process(ranks, mesh, mode):
    """Four ranks at (data 2, model 2) and (data 1, model 4): each rank's
    three steps of ``mode`` against one process on the global batches."""
    k = MODES.index(mode)
    for r in ranks["four"]:
        _assert_runs_match(r[mesh][k], ranks["single"][mesh][k], EXP["LR"],
                           STEPS)


# --- (c) against JAX's FSDP step on a model axis -----------------------------

@pytest.mark.parametrize("mode", MODES)
def test_tp_step_matches_the_jax_fsdp_step_on_a_model_axis(ranks, mode):
    """One step of ``mode`` with the draws of JAX's FSDP step on a (data
    1, model 2) mesh replayed on each rank: metrics, ``grad_norm``, the
    gathered gradients and the parameters after Adam against JAX's step,
    whose updated parameters kept their split over ``model``."""
    from ctvae_torch.models import build_model
    j_params, j_grads, j_metrics, _, _, split = ranks["jax"]["float32", mode]
    assert split
    tm = build_model(dict(SMALL), device="cpu")
    for r in ranks["replay"]:
        got = r["ct"][MODES.index(mode)]
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


# --- (d) the blocks, the ranks, the norms ------------------------------------

def _block(full, split, mi, m, di, d):
    md, dd = split
    if md is not None:
        full = full.chunk(m, dim=md)[mi]
    if dd is not None:
        full = full.chunk(d, dim=dd)[di]
    return full


def _runs_of(ranks, name):
    """[(rank, data index, model index, data size, model size, result)]
    of the run ``name`` (ranks model-minor)."""
    if name in ranks["gen"][0]:
        results, (d, m) = [r[name] for r in ranks["gen"]], MESHES[
            "data1_model2"]
    else:
        results, (d, m) = [r[name] for r in ranks["four"]], MESHES[name]
    return [(i, i // m, i % m, d, m, res) for i, res in enumerate(results)]


@pytest.mark.parametrize("name", ["tp", "data2_model2", "data1_model4"])
def test_each_rank_holds_its_block_and_its_moments(ranks, name):
    """Each rank's block of every split leaf is block (model index) along
    the model dim and, inside it, block (data index) along the data dim
    of the full parameter; its Adam moments have the block's shape; the
    bytes resident between steps are the blocks', the replicated
    parameters' and their moments'."""
    for _, di, mi, d, m, results in _runs_of(ranks, name):
        for res in results:
            plan = res["plan"]
            assert plan and set(res["slices"]) == set(plan)
            for n, split in plan.items():
                assert torch.equal(res["slices"][n], _block(
                    res["params"][n], split, mi, m, di, d)), n
            moments = res["moments"][0]
            want = 0
            for n, p in res["params"].items():
                shape = tuple(_block(p, plan[n], mi, m, di, d).shape) \
                    if n in plan else tuple(p.shape)
                if n in moments:
                    assert moments[n] == shape, n
                want += int(np.prod(shape)) * p.element_size() * (
                    3 if n in moments else 1)
            assert res["resident_bytes"] == want


@pytest.mark.parametrize("name", ["tp", "clip", "data2_model2",
                                  "data1_model4"])
def test_ranks_end_bit_identical(ranks, name):
    """Every rank's gathered parameters, buffers and last metrics equal
    rank 0's bit for bit: the replicated leaves' gradients, broadcast
    from each model group's first rank, keep the group equal."""
    runs = _runs_of(ranks, name)
    first = runs[0][-1]
    for *_, results in runs[1:]:
        for a, b in zip(results, first):
            for part in ("params", "buffers"):
                for n, t in b[part].items():
                    assert torch.equal(a[part][n], t), (part, n)
            assert torch.equal(a["metrics"][-1]["grad_norm"],
                               b["metrics"][-1]["grad_norm"])


def test_grad_norm_and_the_clip_are_global(ranks):
    """With ``gradient_clip_val`` below the step's gradient norm, one step
    per mode: ``grad_norm``, the per-module norms of ``watch_gradients``
    and the clipped update are one process's (the split leaves' squares
    summed over the data and model groups)."""
    for r in ranks["gen"]:
        for got, want in zip(r["clip"], ranks["single"]["clip"]):
            assert float(want["metrics"][0]["grad_norm"]) > 2 * CLIP
            assert {"grad_norm/ct_layer", "param_norm/vq_layer"} <= set(
                got["metrics"][0])
            _assert_runs_match(got, want, EXP["LR"], 1)


# --- (e) the loop and checkpoints --------------------------------------------

def test_tp_fit_resumes_bit_for_bit(ranks):
    """``fit`` under ``sharding: fsdp`` with ``model_axis: 2``: every rank
    restores rank 0's ``last`` into its blocks (equal to what it saved)
    and trains on: the same state, bit for bit, as the epochs without a
    stop; the discoverer is split over ``model``."""
    for res in ranks["fit"]:
        assert res["plan"]["ct_layer.disc_w1l"][0] is not None
        assert res["restored_equal"]
        assert res["resumed_step"] == res["straight_step"] > 0
        for n, t in res["straight"].items():
            assert torch.equal(res["resumed"][n], t), n


@pytest.mark.parametrize("src", ["tp", "fsdp", "dp", "single"])
def test_checkpoints_move_between_tp_fsdp_dp_and_one_process(ranks, src):
    """A checkpoint of FSDP ranks with a model axis, of FSDP ranks over
    ``data``, of DP ranks or of one process restored into each of those:
    the state (parameters, both Adam moments, step counts, step,
    generator) then equals the file's, bit for bit."""
    for res in ranks["fit"]:
        for dst in ("tp", "fsdp", "dp", "single"):
            assert res["moves"][f"{src}-{dst}"] == [], dst


# --- (f) bfloat16 ------------------------------------------------------------

def test_tp_bf16_causal_step_matches_jax(ranks):
    """bfloat16 at (data 1, model 2), the causal step with JAX's draws and
    decisions replayed on each rank: losses, ``grad_norm``, every gradient
    leaf and every parameter after Adam against JAX's bfloat16 FSDP step
    on the same mesh, within twice the further of JAX's and the port's
    single bfloat16 process's distance to the port's float32 step;
    the blocks and their moments bfloat16 where the parameter is."""
    j = ranks["jax"]["bfloat16", "causal"]
    assert jnp.bfloat16 in j[5]
    for r in ranks["replay"]:
        got = r["bf16"][0]
        _assert_matches_jax(got, ranks["single_bf16"][0], ranks["twin"][0],
                            j, CT_BF16, "ct")
        dtypes = got["moment_dtypes"][0]
        for n in got["plan"]:
            if n in dtypes:
                assert dtypes[n] == (got["params"][n].dtype,) * 3, n
        assert got["slices"]["ct_layer.disc_w1l"].dtype == torch.bfloat16


# --- (g) scan_steps over gloo ------------------------------------------------

@pytest.mark.parametrize("k", SCAN_KS)
@pytest.mark.parametrize("sharding", SCAN_SHARDINGS)
def test_scan_steps_over_gloo_equal_single_steps(ranks, sharding, k):
    """``make_multi_train_step(causal, K)`` over two gloo ranks (under
    ``dp``: a batch group of two; under ``fsdp`` with a model axis and
    ``sp``: a model group of two) runs eagerly (``graphed`` False) into
    the state of K single steps bit for bit: the last metrics and
    gradients, the parameters and buffers, the step; the single steps
    against one process on the global batches."""
    i = SCAN_KS.index(k)
    name = f"scan_{sharding}"
    want_one = ranks["single"][name][i]
    for r in ranks["gen"]:
        scanned, stepped = r[name][2 * i], r[name][2 * i + 1]
        assert scanned["graphed"] is False
        assert scanned["step"] == stepped["step"] == k
        for key, v in stepped["metrics"][-1].items():
            assert torch.equal(scanned["metrics"][0][key], v), key
        for n, g in stepped["grads"][-1].items():
            assert torch.equal(scanned["grads"][0][n], g), n
        for part in ("params", "buffers"):
            for n, t in stepped[part].items():
                assert torch.equal(scanned[part][n], t), (part, n)
        _assert_runs_match(stepped, want_one, EXP["LR"], k)
