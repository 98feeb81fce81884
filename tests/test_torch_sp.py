"""Sequence parallelism of the port (``exp_params.sharding: sp``,
``ctvae_torch/parallel/sequence.py``) on the CPU: gloo ranks, each its own
process (``tests/torch_dp_ranks.py``, which imports nothing of JAX), whose
mesh has a ``model`` axis; the CT model, built with ``seq_axis="model"``,
runs the pairwise and GATv2 kernels' plain versions on each rank's block
of target nodes and gathers the blocks.

The small CT model has S = 32 latent sites and T = 33 GAT nodes (one
action node), so its node axis splits unevenly: 17 + 16 at a model axis
of 2, 9 + 8 + 8 + 8 at 4.

- The ranks against one process on the global batch (generator-drawn
  steps from one state): every loss and metric, ``grad_norm`` and every
  parameter's gradient within the bounds of
  ``test_dp_steps_equal_one_process_on_the_global_batch`` (1e-5, each
  gradient at its leaf's scale), on (data 1, model 2) in each mode and on
  (data 2, model 2), (replica 2, data 1, model 2) and (data 1, model 4)
  in the causal mode. On (data 1, model 2) the forward is bit-equal: every
  loss term equals one process's.
- The ranks against JAX's SP step on a (1, 2) mesh of two CPU devices
  (``seq_axis="model"``: XLA splits the same domains), its draws
  replayed, to the bounds of ``test_dp_step_matches_jax_on_the_global_batch``.
- The split: every ``ctvae::`` pairwise, GAT and GAT-logits call of a
  rank's step took the rank's block of targets, and GAT's saved alpha is
  [B, H, T_block, T].
- ``sharding: dp`` with ``model_axis: 2``: both ranks load the same rows
  and train as one process, bit for bit (nothing is split, and a batch
  group of one rank leaves every mean exact).
- ``run.train`` under ``sharding: sp`` (``seq_axis`` injected) with image
  grids, which rank 0 draws alone outside the split, and a metric; rank
  0 alone writes; a resume continues bit for bit.
- bfloat16 (causal mode): each gradient within twice the one process's
  bfloat16 distance to its float32 step, plus 2 ulps of its norm.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import (EXP, FIT, MODES, RANK_TIMEOUT, ROWS,
                                 _close_tol, _global_batch, finish, send,
                                 start)
from torch_port_common import (SMALL, assert_step_matches, close,
                               one_torch_thread, port_pair, recorded_draws,
                               t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SP = dict(SMALL, seq_axis="model")
S, T = 32, 33                       # SMALL's latent sites and GAT nodes
TOL = 1e-5                          # ranks against one process
ULP = 2.0 ** -8                     # one bfloat16 ulp, relative
#: the world-4 meshes of the causal step: (dcn_replicas, model_axis)
MESHES = {"data2_model2": (1, 2), "replica2_data1_model2": (2, 2),
          "data1_model4": (1, 4)}
#: the kernels' ops, by what holds their target axis: (argument index,
#: dim) of the block of targets
SPLIT_OPS = {"pairwise_fwd": (1, 1), "pairwise_bwd": (1, 1),
             "gat_fwd_alpha": (1, 1), "gat_bwd": (1, 1),
             "gat_logits_fwd": (1, 1), "gat_logits_bwd": (1, 1)}


def _batch(seed: int, rows: int):
    b = _global_batch("ct", seed)
    if rows > len(b["image"]):
        more = _global_batch("ct", seed + 1000)
        b = {k: np.concatenate([v, more[k]]) for k, v in b.items()}
    return {k: v[:rows] for k, v in b.items()}


def _spec(cfg, state_dict, mesh, runs):
    return {"cfg": cfg, "exp": EXP, "state_dict": state_dict, "mesh": mesh,
            "runs": runs}


# --- (a) the blocks ----------------------------------------------------------

@pytest.mark.parametrize("n_targets", [17, 64, 65])
@pytest.mark.parametrize("m", [2, 4])
def test_target_blocks_cover_every_target_once(n_targets, m):
    """Every target in exactly one block, in rank order, the blocks'
    sizes within one of each other (65 over 2: 33 + 32); more ranks than
    targets raise."""
    from ctvae_torch.parallel.sequence import target_blocks
    blocks = target_blocks(n_targets, m)
    assert len(blocks) == m and blocks[0][0] == 0
    assert blocks[-1][1] == n_targets
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [b - a for a, b in blocks]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]
    if n_targets == 65 and m == 2:
        assert sizes == [33, 32]
    with pytest.raises(ValueError):
        target_blocks(m - 1, m)


# --- the ranks ---------------------------------------------------------------

def _jax_sp_step(jm, variables, mode, b, mp, seed):
    """JAX's train step over a (data 1, model 2) mesh of two CPU devices,
    the model's ``seq_axis="model"`` pinning the target axes to
    ``model``, traced here with its draws recorded; returns a function
    that compiles and runs it (on a thread) and returns (params, raw
    gradients, metrics), and the draws."""
    import optax

    from ctvae_tpu.parallel.mesh import make_mesh, put_replicated, shard_batch
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    from torch_port_common import keep_grads
    mesh = make_mesh(jax.devices()[:2], model_axis=2)
    params = variables["params"]
    tx = optax.chain(keep_grads(), jopt.build_optimizers(EXP, params, 4)[0])
    with mesh:
        state = put_replicated(jstate.TrainState(
            step=jnp.array(0, jnp.int32), params=params, model_state={},
            opt_states=(tx.init(params),), rng=jax.random.PRNGKey(seed)),
            mesh)
        fn = jstate.make_train_step(
            jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
            static_fwd_kwargs={"mode": mode})
        batch = shard_batch(b, mesh)
        with recorded_draws(mp, seed=seed) as rec:
            lowered = jax.jit(fn).lower(state, batch)
    if mode == "causal":
        # JAX splits: its step carries the target axes' constraints
        assert lowered.as_text().count("sharding_constraint") >= 4

    def run():
        with mesh:
            new, metrics = lowered.compile()(state, batch)
        return (jax.device_get(new.params),
                jax.device_get(new.opt_states[0][0]),
                jax.device_get(metrics))
    return run, rec.draws


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawns of this module, started at once: two ranks (the
    generator-drawn steps of each mode and the causal one at bfloat16,
    the loop, then the replays of JAX's steps, whose payload they wait
    for) and four (the causal step over three meshes), rank 0 of each
    then one process on the same global batches; meanwhile JAX's SP steps
    traced here, their draws sent to the two ranks, and JAX compiled."""
    from concurrent.futures import ThreadPoolExecutor

    from ctvae_torch.models import build_model

    def init(cfg):
        return build_model(dict(cfg), device="cpu",
                           generator=torch.Generator().manual_seed(2)
                           ).state_dict()
    bf = dict(SP, dtype="bfloat16")
    sd, bf_sd = init(SP), init(bf)
    gen = {
        "ct": _spec(SP, sd, (1, 2), [
            {"seed": 7 + i, "record_ops": True,
             "steps": [(mode, _batch(51 + i, ROWS), None)]}
            for i, mode in enumerate(MODES)]),
        "bf16": _spec(bf, bf_sd, (1, 2), [
            {"seed": 9, "steps": [("causal", _batch(57, ROWS), None)]}])}
    four = {name: _spec(SP, sd, mesh, [{"seed": 11, "steps": [
        ("causal", _batch(61, 2 * ROWS if mesh[1] == 2 else ROWS), None)]}])
        for name, mesh in MESHES.items()}
    tmp = tmp_path_factory.mktemp("sp_ranks")
    b = _global_batch("ct", 61)
    fit = dict(FIT, root=str(tmp / "fit"), config=_config(),
               batch={k: v[:ROWS] for k, v in b.items()})
    def one_process(spec):
        return {**spec, "mesh": None, "runs": [
            {k: v for k, v in run.items() if k != "record_ops"}
            for run in spec["runs"]]}
    # rank 0 of each spawn also runs one process on the global batches
    # (and the float32 twin of bf16) once its ranks' work is done
    twin = {**gen["bf16"], "cfg": SP, "state_dict": {
        k: v.float() if v.is_floating_point() else v
        for k, v in bf_sd.items()}}
    spawns = {
        "two": start("sp", {"gen": {"models": gen, "single": {
            name: one_process(spec)
            for name, spec in {**gen, "twin": twin}.items()}},
            "fit": fit, "replay": str(tmp / "replay.pt")}, tmp),
        "four": start("steps", {"models": four, "single": {
            name: one_process(spec) for name, spec in four.items()}},
            tmp_path_factory.mktemp("sp_four"), world=4)}
    jm, variables, tm = port_pair(SP, seed=1)
    mp = pytest.MonkeyPatch()
    runs, batches = {}, {}
    try:
        for i, mode in enumerate(MODES):
            batches[mode] = _batch(31 + i, ROWS)
            runs[mode] = _jax_sp_step(
                jm, variables, mode,
                {k: jnp.asarray(v) for k, v in batches[mode].items()}, mp,
                seed=41 + i)
    finally:
        mp.undo()
    # the traces recorded the draws: the ranks replay them while JAX
    # compiles
    replay = _spec(SP, tm.state_dict(), (1, 2), [
        {"steps": [(mode, batches[mode], runs[mode][1])]} for mode in MODES])
    send(tmp / "replay.pt", {"models": {"ct": replay}})
    with ThreadPoolExecutor(len(runs)) as pool:
        jax_ref = dict(zip(runs, pool.map(lambda run: run[0](),
                                          runs.values())))
    two = finish(spawns["two"], timeout=2 * RANK_TIMEOUT)
    four = finish(spawns["four"], timeout=2 * RANK_TIMEOUT)
    single = {**two[0]["single"], **four[0].pop("single")}
    return {"jax": jax_ref, "single": single, "twin": single.pop("twin"),
            "specs": {"replay": replay},
            "gen": [r["gen"] for r in two],
            "replay": [r["replay"] for r in two],
            "fit": ([r["fit"] for r in two], fit["root"]), "four": four}


def _assert_equal_to_one_process(got, want, bit_equal_forward=False):
    """A rank's run against one process's: every metric (with
    ``bit_equal_forward`` each loss term bit for bit) and every
    gradient, at the DP tests' bounds."""
    assert got["step"] == want["step"]
    for m_got, m_want in zip(got["metrics"], want["metrics"]):
        assert set(m_got) == set(m_want)
        for key in m_want:
            _close_tol(m_got[key], m_want[key])
            if bit_equal_forward and key != "grad_norm":
                assert torch.equal(m_got[key], m_want[key]), key
    for g_got, g_want in zip(got["grads"], want["grads"]):
        assert set(g_got) == set(g_want)
        for n, g in g_want.items():
            scale = max(1.0, float(g.abs().max()))
            close(t2n(g_got[n]), t2n(g), atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_sp_step_equals_one_process_on_the_global_batch(ranks, mode):
    """(data 1, model 2): each rank's losses, the model's metrics,
    ``grad_norm`` and every parameter's gradient against one process;
    the loss terms bit for bit."""
    k = MODES.index(mode)
    want = ranks["single"]["ct"][k]
    for r in ranks["gen"]:
        _assert_equal_to_one_process(r["ct"][k], want,
                                     bit_equal_forward=True)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_world_of_4_equals_one_process(ranks, mesh):
    """The causal step on four ranks: (data 2, model 2), (replica 2, data
    1, model 2) and (data 1, model 4) against one process on the global
    batch, and the ranks of each model group bit-identical."""
    want = ranks["single"][mesh][0]
    for r in ranks["four"]:
        _assert_equal_to_one_process(r[mesh][0], want)
    m = MESHES[mesh][1]
    for r0, r1 in zip(ranks["four"][::m], ranks["four"][1::m]):
        for n, t in r0[mesh][0]["params"].items():
            assert torch.equal(t, r1[mesh][0]["params"][n]), n


@pytest.mark.parametrize("mode", MODES)
def test_sp_step_matches_the_jax_sp_mesh_step(ranks, mode):
    """One step with JAX's draws replayed: each rank's metrics,
    ``grad_norm``, gradients and parameters after Adam against JAX's step
    on a (1, 2) mesh with ``seq_axis="model"``."""
    from ctvae_torch.models import build_model
    j_params, j_grads, j_metrics = ranks["jax"][mode]
    k = MODES.index(mode)
    spec = ranks["specs"]["replay"]
    tm = build_model(dict(spec["cfg"]), device="cpu")
    for r in ranks["replay"]:
        got = r["ct"][k]
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
def test_sp_kernels_take_the_ranks_block_of_targets(ranks, mode):
    """Every pairwise, GAT and GAT-logits op call of a rank's step took
    the rank's block of targets (pairwise: 16 of S = 32 columns; GAT:
    17 / 16 of T = 33 nodes), each of the six ran, GAT's saved alpha is
    [B, H, T_block, T], and the VQ search is not split."""
    from ctvae_torch.parallel.sequence import target_blocks
    k = MODES.index(mode)
    for rank, r in enumerate(ranks["gen"]):
        calls = r["ct"][k]["ops"][0]
        seen = {name for name, _, _ in calls}
        assert set(SPLIT_OPS) <= seen and "vq_l2_argmin" in seen, seen
        for name, args, outs in calls:
            if name not in SPLIT_OPS:
                continue
            n = S if name.startswith("pairwise") else T
            lo, hi = target_blocks(n, 2)[rank]
            i, d = SPLIT_OPS[name]
            assert args[i][d] == hi - lo, (name, args)
            assert args[0][1] == n, (name, args)       # every source
            if name == "gat_fwd_alpha":
                B, H = args[0][0], args[0][2]
                assert outs[1] == (B, H, hi - lo, T), outs


def test_sp_bf16_causal_step_within_bf16_rounding(ranks):
    """bfloat16, causal mode, (data 1, model 2): each rank's gradient
    leaves within twice the one process's bfloat16 distance to its
    float32 step plus 2 bfloat16 ulps of the leaf's norm, and its losses
    within 2 % of the one process's."""
    single, twin = ranks["single"]["bf16"][0], ranks["twin"][0]
    for r in ranks["gen"]:
        got = r["bf16"][0]
        for key in ("loss", "Reconstruction_Loss", "CT_Loss"):
            close(t2n(got["metrics"][0][key]), t2n(single["metrics"][0][key]),
                  atol=1e-6, rtol=2e-2)
        for n, w in twin["grads"][0].items():
            g = got["grads"][0][n].double()
            o = single["grads"][0][n].double()
            r32 = w.double()
            bound = 2 * float((o - r32).norm()) + 2 * ULP * float(r32.norm())
            assert float((g - r32).norm()) <= bound, n


# --- the loop ----------------------------------------------------------------

YAML_MODEL = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
                  action_dim=8, hidden_dims=[8, 16], num_embeddings=8,
                  img_size=16, codebooks=2, causal_hidden_dims=[16, 8])


def _config():
    """``run.train``'s config under ``sharding: sp`` (as read from a
    YAML), with one metric."""
    return {"model_params": dict(YAML_MODEL),
            "data_params": dict(data_path="", dataset_name="TSynthetic",
                                train_batch_size=ROWS, val_batch_size=ROWS,
                                patch_size=16, limit=4, val_limit=4),
            "exp_params": dict(EXP, manual_seed=1265, sharding="sp",
                               metrics=["MIG"]),
            "trainer_params": {"max_epochs": 1},
            "logging_params": {"save_dir": "logs/", "name": "CTMCQVAE"}}


def test_dp_over_a_model_axis_repeats_the_rows(ranks):
    """``sharding: dp`` with ``model_axis: 2`` at a world of 2: the mesh
    (data 1, model 2), both ranks load the same rows (data index 0 of 1)
    and nothing is split; a step per mode equals one process's bit for
    bit."""
    results, _ = ranks["fit"]
    for res in results:
        assert res["dp_mesh"] == (("data", "model"), (1, 2))
        assert res["dp_hosts"] == (0, 1) and res["dp_seq_axis"] is None
        assert np.array_equal(res["dp_first"], results[0]["dp_first"])
    want = results[0]["one_params"]       # rank 0's one process
    for res in results:
        for n, t in want.items():
            assert torch.equal(res["dp_params"][n], t), n


def test_sp_run_train_writes_on_rank_0_and_resumes_bit_for_bit(ranks):
    """``run.train`` under ``sharding: sp`` at a world of 2: it built the
    model with ``seq_axis="model"``, rank 0 alone wrote the run (image
    grids, checkpoints) and the metric is in its validation; a resume
    from rank 0's ``last`` trains the second epoch into the state of two
    epochs straight, bit for bit; the ranks validate alike."""
    results, _ = ranks["fit"]
    for res in results:
        assert res["built"] == ["model"]
        assert res["runs"] == ["version_0", "version_1"]
        assert all(len(v) == 1 for v in res["grids"].values()), res["grids"]
        assert res["resume_differs"] == [], res["resume_differs"]
        # the metric's keys (val_<name>.<score>) beside the eval step's
        assert any(k.startswith("val_") and "." in k for k in res["first"])
        # the ranks validate alike (the eval draws restart at a resume,
        # so the resumed run's validation is not the straight run's)
        for key in ("first", "second", "straight"):
            assert _val(res[key]) == _val(results[0][key])
    assert results[0]["saves"] and not results[1]["saves"]


def _val(out):
    return {k: v for k, v in out.items() if k.startswith("val_")}


def test_the_spmd_export_still_raises():
    """An export over a mesh (JAX's ``export_fn(mesh=...)``) is not ported:
    it raises naming ROADMAP A8.3 before tracing anything."""
    from ctvae_torch.serving.export import export_fn
    with pytest.raises(NotImplementedError, match="ROADMAP A8.3"):
        export_fn(None, (), mesh=object())
