"""Data-parallel training of the port (``ctvae_torch/parallel/``) on the
CPU: two ranks of a gloo group, each its own process
(``tests/torch_dp_ranks.py``, which imports nothing of JAX), against the
port's single process on the global batch and against the JAX step.

A global batch of 4 rows is split 2 + 2. The ranks must compute what one
process computes on all 4 rows, which the JAX package computes over a
sharded global array: the draws (each rank's rows of the global draws,
causal mode's virtual batch action-major), the gradient (the ranks'
mean), ``grad_norm``, BatchNorm's statistics and running buffers, and the
EMA codebook's counts, sums and revival, GammaVAE's gamma draw. Tolerances: against one process
each loss, metric and ``grad_norm`` within 1e-5 (atol and rtol), each
gradient within 1e-5 of its leaf's scale, each buffer within 1e-5, each
parameter within the steps' count times 1e-5 plus LR / 1e-8 times the
sum over the steps of its gradient's difference (Adam moves a parameter
by LR g / (|g| + 1e-8), so a gradient of rounding noise moves it by a
fraction of LR that differs between the two, as in
``torch_port_common.assert_steps_match``); against JAX the tolerances of
``tests/test_torch_training.py`` and ``tests/test_torch_zoo.py``; between
the ranks bit for bit.

Each spawn of ranks has its own time limit (``RANK_TIMEOUT``) and kills
its ranks when it fails.
"""

import copy
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from test_torch_zoo import _assert_step_matches as assert_step_matches_bn
from torch_dp_ranks import run_steps
from torch_port_common import (SMALL, assert_step_matches, batch, build_pair,
                               close, jax_train_step_state, one_torch_thread,
                               t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ROWS = 2, 2                  # ranks, rows per rank
RANK_TIMEOUT = 120                  # seconds per spawn of ranks
TOL = 1e-5                          # ranks against one process
EXP = dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0)
EXP_ZOO = dict(LR=5e-3, weight_decay=0.0, scheduler_gamma=0.95)
MODES = ("base", "action", "causal")
# decay 0.9 and threshold 0.5: the revival re-seeds some codes each step
EMA = dict(ema=True, ema_decay=0.9, revive_threshold=0.5)
VANILLA = dict(name="VanillaVAE", in_channels=3, latent_dim=8,
               hidden_dims=[8, 16], img_size=16)
# its gamma draw's stream depends on every element's shape, so a rank
# gathers the global alpha first (ShardedDraws.gamma)
GAMMA = dict(VANILLA, name="GammaVAE", gamma_shape=8.0, prior_shape=2.0,
             prior_rate=1.0)
#: model -> (config, optimizer settings, modes, generator-drawn steps per
#: mode). The zoo's models take one: the conv bias before each of their
#: BatchNorms has a gradient of pure rounding noise, which Adam turns
#: into a move of up to LR that differs between any two runs, and the
#: next step's batch statistics (so the running ones) carry it
MODELS = {"ct": (SMALL, EXP, MODES, 3),
          "ct_ema": (dict(SMALL, **EMA), EXP, MODES, 3),
          "vanilla": (VANILLA, EXP_ZOO, ("base",), 1),
          "gamma": (GAMMA, EXP_ZOO, ("base",), 1)}
ZOO = ("vanilla", "gamma")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                               "tests")]))


def _wait_all(procs, log, timeout):
    """Wait for every process; on a time-out or a failure kill them all
    and fail with the log."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            p.kill()
            p.wait()
    text = open(log).read()
    assert not alive, f"ranks still running after {timeout} s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text


def start(case, payload, tmp, world=WORLD):
    """Start ``case`` of ``torch_dp_ranks`` on ``world`` ranks; ``finish``
    collects it."""
    tmp = str(tmp)
    path = os.path.join(tmp, "payload.pt")
    torch.save(payload, path)
    port = _free_port()
    log = os.path.join(tmp, "ranks.log")
    with open(log, "w") as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
             case, str(r), str(world), str(port), path, tmp],
            env=_env(), cwd=tmp, stdout=out, stderr=subprocess.STDOUT)
            for r in range(world)]
    return procs, log, tmp, time.monotonic()


def finish(started, timeout=RANK_TIMEOUT):
    """Each rank's result of a ``start``, within ``timeout`` seconds of
    the start."""
    procs, log, tmp, t0 = started
    _wait_all(procs, log, timeout - (time.monotonic() - t0))
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]
    for o in outs:
        assert o["ok"], o.get("error")
    return [o["result"] for o in outs]


# --- train steps: one process, two ranks, JAX ----------------------------------

def _zoo_pair(cfg):
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    jm = jax_build(dict(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    x = np.random.default_rng(0).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        dict(zip(("params", "reparam", "gumbel", "noise", "dropout"), keys)),
        jnp.asarray(x)))
    tm = build_model(dict(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm))
    return jm, variables, tm


def _global_batch(model: str, seed: int):
    x, y, a = batch(seed, B=WORLD * ROWS)
    if model in ZOO:
        return {"image": x}
    return {"image": x, "input_y": y, "action": a}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The ranks of the loop and of the refusals, started first: they run
    while the steps' JAX references compile."""
    fit_tmp = tmp_path_factory.mktemp("dp_fit")
    return {"fit": (start("fit", dict(FIT, root=str(fit_tmp)), fit_tmp),
                    str(fit_tmp)),
            "misc": start("misc", _misc_payload(),
                          tmp_path_factory.mktemp("dp_misc"))}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, background):
    """Per model: the JAX step of each mode on a global batch with its
    draws recorded, replayed on each of two ranks; the generator-drawn
    steps of each mode in one process and on each of two ranks."""
    pairs = {name: (_zoo_pair(cfg) if name in ZOO
                    else build_pair(dict(cfg), seed=0))
             for name, (cfg, *_) in MODELS.items()}
    specs = {name: {"cfg": dict(cfg), "exp": exp,
                    "state_dict": copy.deepcopy(pairs[name][2].state_dict())}
             for name, (cfg, exp, *_) in MODELS.items()}
    # the generator-drawn runs go first, on ranks that run while JAX does
    gen = {name: {**spec, "runs": [
        {"seed": 7 + i, "steps": [
            (mode, _global_batch(name, 51 + 3 * i + k), None)
            for k in range(MODELS[name][3])]}
        for i, mode in enumerate(MODELS[name][2])]}
        for name, spec in specs.items()}
    gen_ranks = start("steps", {"models": gen},
                      tmp_path_factory.mktemp("dp_steps_gen"))
    mp = pytest.MonkeyPatch()
    jax_ref, replay = {}, {}
    try:
        for name, (cfg, exp, modes, _) in MODELS.items():
            jm, variables, _ = pairs[name]
            runs, jax_ref[name] = [], {}
            for i, mode in enumerate(modes):
                b = _global_batch(name, 31 + i)
                j = jax_train_step_state(
                    jm, variables, mode,
                    {k: jnp.asarray(v) for k, v in b.items()}, mp,
                    seed=41 + i, exp=exp)
                jax_ref[name][mode] = j
                runs.append({"steps": [(mode, b, j[3])]})
            replay[name] = {**specs[name], "runs": runs}
    finally:
        mp.undo()
    replay_ranks = start("steps", {"models": replay},
                         tmp_path_factory.mktemp("dp_steps_replay"))
    # one process runs the generator-drawn runs on the global batches
    single = {name: run_steps(spec) for name, spec in gen.items()}
    gen_ranks, replay_ranks = finish(gen_ranks), finish(replay_ranks)
    ranks = [{name: r[name] + g[name] for name in MODELS}
             for r, g in zip(replay_ranks, gen_ranks)]
    single = {name: [None] * len(MODELS[name][2]) + single[name]
              for name in MODELS}
    return {"jax": jax_ref, "single": single, "ranks": ranks,
            "specs": {name: {**specs[name], "runs": replay[name]["runs"]}
                      for name in MODELS}}


def _cases():
    return [(name, mode) for name, (_, _, modes, _) in MODELS.items()
            for mode in modes]


def _close_tol(got, want):
    close(t2n(got), t2n(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,mode", _cases())
def test_dp_steps_equal_one_process_on_the_global_batch(steps, name, mode):
    """The generator-drawn steps of ``mode``: each rank's
    metrics (losses, ``grad_norm``, the model's metrics), gradients,
    parameters and buffers against one process on the global batches."""
    modes = MODELS[name][2]
    k = len(modes) + modes.index(mode)
    want = steps["single"][name][k]
    lr, n_steps = MODELS[name][1]["LR"], MODELS[name][3]
    for got in (r[name][k] for r in steps["ranks"]):
        assert got["step"] == want["step"] == n_steps
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            assert set(m_got) == set(m_want)
            for key in m_want:
                _close_tol(m_got[key], m_want[key])
        # n_steps x the bound of one step, as assert_steps_match
        diff = {n: torch.zeros_like(p) for n, p in want["params"].items()}
        for g_got, g_want in zip(got["grads"], want["grads"]):
            assert set(g_got) == set(g_want)
            for n, g in g_want.items():
                scale = max(1.0, float(g.abs().max()))
                close(t2n(g_got[n]), t2n(g), atol=TOL * scale, rtol=0)
                diff[n] += (g_got[n] - g).abs()
        assert set(got["params"]) == set(want["params"])
        for n, p in want["params"].items():
            tol = n_steps * (TOL + lr / 1e-8 * diff[n])
            assert bool(((got["params"][n] - p).abs() <= tol).all()), n
        assert set(got["buffers"]) == set(want["buffers"])
        for n, t in want["buffers"].items():
            _close_tol(got["buffers"][n], t)


@pytest.mark.parametrize("name,mode", _cases())
def test_dp_step_matches_jax_on_the_global_batch(steps, name, mode):
    """One step of ``mode`` with JAX's draws of the global batch replayed
    (each rank its rows): each rank's metrics, ``grad_norm``, gradients,
    parameters after Adam and the written buffers (``vq_stats``,
    ``batch_stats``) against the JAX step on the global batch."""
    j_params, j_grads, j_metrics, _, j_state = steps["jax"][name][mode]
    k = MODELS[name][2].index(mode)
    exp = MODELS[name][1]
    tm = build_pair_model(steps["specs"][name])
    for r in steps["ranks"]:
        got = r[name][k]
        metrics = got["metrics"][0]
        assert set(metrics) == set(j_metrics)
        for key, v in j_metrics.items():
            close(t2n(metrics[key]), v, atol=1e-6 if name in ZOO
                  else 1e-5, rtol=1e-4)
        close(t2n(metrics["grad_norm"]), j_metrics["grad_norm"], atol=0,
              rtol=1e-5)
        with torch.no_grad():
            for n, p in tm.named_parameters():
                p.copy_(got["params"][n])
                p.grad = got["grads"][0].get(n)
        check = (assert_step_matches_bn if name in ZOO
                 else assert_step_matches)
        check(tm, j_params, j_grads, exp["LR"])
        if j_state:
            want = from_jax_params({"params": j_params, **j_state}, tm)
            for n, t in got["buffers"].items():
                if n in want:
                    close(t2n(t), want[n].numpy(), atol=1e-5, rtol=1e-4)


def build_pair_model(spec):
    from ctvae_torch.models import build_model
    tm = build_model(dict(spec["cfg"]), device="cpu")
    tm.load_state_dict(spec["state_dict"])
    return tm


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_ranks_end_bit_identical(steps, name):
    """After every run the two ranks' parameters and buffers are equal bit
    for bit, and the buffers the step writes moved."""
    r0, r1 = (r[name] for r in steps["ranks"])
    for a, b in zip(r0, r1):
        for part in ("params", "buffers"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (part, n)
    init = steps["specs"][name]["state_dict"]
    written = [n for n in r0[-1]["buffers"] if n in init
               and not n.endswith("pe_table")]
    assert bool(written) == (name != "ct")
    for n in written:
        assert not torch.equal(r0[-1]["buffers"][n], init[n]), n


def test_dp_ema_revival_and_batch_norm_ran(steps):
    """The checks above see the global paths: the EMA step revived some
    codes (a count of exactly 1 after a step), and each rank's
    BatchNorm running mean is the global batch's, not its own rows'."""
    got = steps["ranks"][0]["ct_ema"][0]["buffers"]
    sizes = [t for n, t in got.items() if n.endswith("cluster_size")]
    assert sizes and all(bool((s == 1.0).any()) for s in sizes)
    spec = steps["specs"]["vanilla"]
    rows = spec["runs"][0]["steps"][0][1]["image"][:ROWS]
    local = run_steps({**spec, "runs": [{"steps": [
        ("base", {"image": rows}, None)]}]})[0]["buffers"]
    dp = steps["ranks"][0]["vanilla"][0]["buffers"]
    n = "encoder.ConvBNBlock_0.BatchNorm_0.running_mean"
    assert n in dp and not torch.allclose(dp[n], local[n], atol=1e-6)


# --- the loop: fit, checkpoints, stop, resume ----------------------------------

FIT = dict(cfg=SMALL, seed=5, stop_rank=1,
           data=dict(data_path="", dataset_name="TSynthetic",
                     train_batch_size=ROWS, val_batch_size=ROWS,
                     patch_size=16, limit=8, val_limit=4, seed=5),
           exp=dict(EXP, kld_weight=1.0))


@pytest.fixture(scope="module")
def fit(background):
    started, root = background["fit"]
    return finish(started), root


def test_fit_ranks_take_the_schedulers_slices(fit):
    """Without host arguments the data module takes the rank and the
    world; each rank's batches are its slice of the scheduler's global
    batches."""
    results, _ = fit
    for r, res in enumerate(results):
        assert res["hosts"] == (r, WORLD)
        assert res["slices_match"] and res["batches_match"]


def test_fit_only_rank_0_writes_checkpoints(fit):
    results, root = fit
    assert results[0]["writes"] and not results[1]["writes"]
    assert results[0]["saves"] and not results[1]["saves"]
    files = sorted(os.listdir(os.path.join(root, "run")))
    assert "last" in files and "index.json" in files
    assert all(s.startswith(os.path.join(root, "run"))
               for s in results[0]["saves"])
    for n, t in results[0]["after_1"].items():
        assert torch.equal(t, results[1]["after_1"][n]), n


def test_fit_stop_on_one_rank_stops_both(fit):
    """SIGTERM on rank 1 alone during epoch 1: both ranks leave ``fit``
    after that epoch's training at the same step, and rank 0 saved it."""
    results, root = fit
    one_epoch = results[0]["step_1"]
    assert one_epoch > 0
    for res in results:
        assert res["stopped_at"] == 2 * one_epoch
    assert results[0]["last_after_stop"] == 2 * one_epoch


def test_fit_resume_continues_bit_for_bit(fit):
    """Every rank restores rank 0's ``last`` and trains the third epoch:
    the same state, bit for bit, as three epochs without a stop."""
    results, _ = fit
    for res in results:
        step = res["stopped_at"]
        assert res["resumed_from"] == (step, 2) and res["restored_equal"]
        assert res["resumed_end"] == res["straight_end"] == 3 * step // 2
        for n, t in res["straight"].items():
            assert torch.equal(res["after_resume"][n], t), n


# --- refusals and dcn_replicas -------------------------------------------------

CROSS_BATCH = {
    "WAE_MMD": dict(VANILLA, name="WAE_MMD"),
    "InfoVAE": dict(VANILLA, name="InfoVAE"),
    "BetaTCVAE": dict(VANILLA, name="BetaTCVAE"),
    "DIPVAE": dict(VANILLA, name="DIPVAE"),
    "SWAE": dict(VANILLA, name="SWAE"),
    "MSSIMVAE": dict(VANILLA, name="MSSIMVAE"),
    "JointVAE": dict(VANILLA, name="JointVAE"),
    "BetaVAE-B": dict(VANILLA, name="BetaVAE", loss_type="B"),
}
PER_ROW = {"VanillaVAE": VANILLA,
           "BetaVAE-H": dict(VANILLA, name="BetaVAE", loss_type="H"),
           "IWAE": dict(VANILLA, name="IWAE"),
           "FactorVAE": dict(VANILLA, name="FactorVAE")}


def _misc_payload():
    _, _, tm = build_pair(SMALL, seed=0)
    b = _global_batch("ct", 61)
    return {"cross_batch": CROSS_BATCH, "per_row": PER_ROW, "ct": SMALL,
            "exp": EXP, "state_dict": tm.state_dict(),
            "batch": {k: v[:ROWS] for k, v in b.items()}}


@pytest.fixture(scope="module")
def misc(background):
    return finish(background["misc"])


@pytest.mark.parametrize("key", list(CROSS_BATCH) + [
    "fsdp", "sp", "model_axis", "seq_axis", "scan_steps"])
def test_refused_under_a_world_of_two(misc, key):
    """Each loss that is not a mean of per-row terms, FSDP, sequence
    parallelism, ``model_axis`` 2, ``seq_axis`` and ``scan_steps`` > 1 over
    gloo raise ``NotImplementedError`` naming ROADMAP A8 on both ranks."""
    for res in misc:
        assert res["refused"][key] == "ok", res["refused"][key]


def test_per_row_losses_are_accepted(misc):
    for res in misc:
        assert set(res["accepted"]) == set(PER_ROW)
        assert all(v == "did not raise" for v in res["accepted"].values())


def test_dcn_replicas_mesh_equals_plain_dp(misc):
    """``dcn_replicas: 2`` over 2 ranks builds the (replica, data, model)
    mesh of shape (2, 1, 1) and trains bit for bit as plain ``dp`` (the
    (data, model) mesh (2, 1)); ``dcn_replicas: 3`` does not divide the
    world and raises."""
    for res in misc:
        replica, data, model = res["mesh_axes"]
        assert res["dp_mesh"] == ((data, model), (2, 1))
        assert res["dcn_mesh"] == ((replica, data, model), (2, 1, 1))
        assert res["dcn_equals_dp"]
        assert res["dcn_3"] == "ok", res["dcn_3"]


# --- no fallback ---------------------------------------------------------------

def test_a_group_that_does_not_come_up_raises(tmp_path):
    """Rank 1 of 2 with no rank 0 behind the address: the group raises
    after its time-out; it does not train as one process."""
    code = (
        "import sys; from ctvae_torch.parallel import init_distributed\n"
        "try:\n"
        f"    init_distributed('gloo', init_method='tcp://127.0.0.1:"
        f"{_free_port()}', rank=1, world_size=2, timeout_s=1)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__); sys.exit(0)\n"
        "sys.exit(1)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "raised" in out.stdout, out.stderr


def test_a_card_past_the_machines_raises(monkeypatch):
    from ctvae_torch import run
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:1"):
        run._torchrun_device(None)
    assert run._torchrun_device("cpu") == torch.device("cpu")


# --- torchrun ------------------------------------------------------------------

YAML = """model_params:
  name: CTMCQVAE
  in_channels: 3
  embedding_dim: 8
  action_dim: 8
  hidden_dims: [8, 16]
  num_embeddings: 8
  img_size: 16
  codebooks: 2
  causal_hidden_dims: [16, 8]
data_params: {{data_path: Data/, dataset_name: TSynthetic, train_batch_size: 2,
  val_batch_size: 2, patch_size: 16, limit: 4, val_limit: 4}}
exp_params: {{LR: 0.0005, weight_decay: 0.0, scheduler_gamma: 1.0,
  manual_seed: 1265}}
trainer_params: {{max_epochs: 1}}
logging_params: {{save_dir: {save_dir}, name: CTMCQVAE}}
"""


def test_torchrun_two_ranks_on_the_cpu(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ctvae_torch.run --device cpu``: both ranks exit 0, and one run
    directory holds the checkpoints."""
    save_dir = tmp_path / "logs"
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(YAML.format(save_dir=save_dir))
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
    runs = sorted(os.listdir(save_dir / "CTMCQVAE"))
    assert runs == ["version_0"], runs
    assert (save_dir / "CTMCQVAE" / "version_0" / "checkpoints" /
            "last").exists()
    assert text.count("epoch 0:") == 1, text
