"""The port's hyperparameter search (``ctvae_torch.hyperparameter_search``)
against the JAX package's root ``hyperparameter_search.py``: the
``to_tune`` sampling, best-trial selection and successive halving, the
config reader against ``yaml.full_load`` on every config (tuples
included), each ``configs_hyp/`` file's trial list against the root
script's, and the CLI end to end on the CPU with PyYAML blocked (fifo on
a CT config with ``noise: endo`` in its space, asha, a late crash,
``parallel_trials``, every trial failing).
"""

import glob
import json
import math
import os
import random
import sys

import pytest
import yaml

import hyperparameter_search as root_hs
from ctvae_torch import hyperparameter_search as hs
from ctvae_torch.config import read_config
from torch_port_common import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYP_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs_hyp", "*.yaml")))
ALL_CONFIGS = HYP_CONFIGS + sorted(glob.glob(os.path.join(REPO, "configs",
                                                          "*.yaml")))
SYNTHETIC = os.path.join(REPO, "configs_hyp", "synthetic_hyp_search.yaml")


# --- sampling and selection ---------------------------------------------------

def test_sample_params_to_tune_semantics():
    """list -> choice, tuple -> uniform, nested-dict spec recursion,
    untouched other keys, seeded reproducibility; equal to the root
    script's draws from the same generator state."""
    config = {
        "model_params": {"latent_dim": [4, 8, 16], "gamma": 0.5,
                         "sub": {"beta": (0.1, 0.9)}},
        "exp_params": {"LR": (0.0005, 0.002), "kld_weight": 0.005},
    }
    spec = {"model_params": {"latent_dim": None, "sub": ["beta"]},
            "exp_params": ["LR"]}
    rng, root_rng = random.Random(0), random.Random(0)
    seen = set()
    for _ in range(50):
        t = hs.sample_params(config, spec, rng)
        assert t == root_hs.sample_params(config, spec, root_rng)
        assert t["model_params"]["latent_dim"] in (4, 8, 16)
        seen.add(t["model_params"]["latent_dim"])
        assert 0.1 <= t["model_params"]["sub"]["beta"] <= 0.9
        assert 0.0005 <= t["exp_params"]["LR"] <= 0.002
        assert t["model_params"]["gamma"] == 0.5
        assert t["exp_params"]["kld_weight"] == 0.005
    assert seen == {4, 8, 16}
    assert config["model_params"]["latent_dim"] == [4, 8, 16]
    t = hs.sample_params({"exp_params": {"LR": (0.1, 0.2), "wd": [0.0, 0.1]}},
                         {"exp_params": ["LR", "wd"]}, random.Random(1))
    assert 0.1 <= t["exp_params"]["LR"] <= 0.2 and t["exp_params"]["wd"] in (
        0.0, 0.1)


def test_select_best_lowest_finite_loss_wins():
    results = [{"trial": 0, "loss": 3.0}, {"trial": 1, "loss": 1.5},
               {"trial": 2, "loss": float("inf")},
               {"trial": 3, "loss": float("nan")}]
    assert hs.select_best(results)["trial"] == 1
    assert hs.select_best([]) is None
    assert hs.select_best(results[2:])["trial"] == 2


# --- successive halving -------------------------------------------------------

def test_run_sha_rungs_and_promotion():
    """8 trials, grace 1, eta 2, max_t 8: budgets 1 / 2 / 4 / 8, the best
    half survives each rung, a trial's budgets only grow."""
    calls = []

    def train_to(tid, epochs):
        calls.append((tid, epochs))
        return float(tid)

    assert hs.run_sha(8, 1, 2, 8, train_to) == [0]
    budgets = {}
    for tid, ep in calls:
        budgets.setdefault(tid, []).append(ep)
    assert sorted(t for t, b in budgets.items() if 2 in b) == [0, 1, 2, 3]
    assert sorted(t for t, b in budgets.items() if 4 in b) == [0, 1]
    assert budgets[0] == [1, 2, 4, 8]


def test_run_sha_culls_failures_and_caps_budget():
    def train_to(tid, epochs):
        assert epochs == 3
        return {1: None, 2: float("nan")}.get(tid, float(tid))

    assert hs.run_sha(4, 5, 2, 3, train_to) == [0, 3, 2]


def test_run_sha_on_cull_and_rung_runner():
    culled, rungs = [], []

    def rung_runner(tids, budget):
        rungs.append((tuple(tids), budget))
        return [(t, float(t)) for t in tids]

    assert hs.run_sha(4, 1, 2, 4, None, rung_runner=rung_runner,
                      on_cull=culled.append) == [0]
    assert rungs == [((0, 1, 2, 3), 1), ((0, 1), 2), ((0,), 4)]
    assert culled == [[2, 3], [1], [0]]
    culled = []
    assert hs.run_sha(4, 1, 2, 4, lambda t, e: None if t == 1 else float(t),
                      on_cull=culled.append) == [0]
    assert culled[0] == [1, 2, 3]


def test_run_sha_lone_survivor_trains_to_max_t():
    seen = []
    assert hs.run_sha(1, 1, 2, 10, lambda t, e: seen.append(e) or 0.0) == [0]
    assert seen == [1, 2, 4, 8, 10]


# --- the config reader and the trial lists ------------------------------------

@pytest.mark.parametrize("path", ALL_CONFIGS, ids=lambda p: os.path.join(
    os.path.basename(os.path.dirname(p)), os.path.basename(p)))
def test_read_config_matches_full_load(path):
    """``read_config`` equals ``yaml.full_load`` on every config: nested
    search specs, flow lists over two lines, ``!!python/tuple``."""
    with open(path) as f:
        want = yaml.full_load(f)
    got = read_config(path)
    assert got == want

    def types(a, b):
        assert type(a) is type(b), (a, b)
        if isinstance(a, dict):
            for k in a:
                types(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b):
                types(x, y)
    types(got, want)


def _trials(config, sample):
    hyp = config.pop("hyperparameter_search")
    rng = random.Random(int(config.get("exp_params", {}).get("manual_seed",
                                                             0)))
    return [sample(config, hyp.get("params", {}), rng)
            for _ in range(int(hyp.get("num_samples", 10)))]


@pytest.mark.parametrize("path", HYP_CONFIGS, ids=os.path.basename)
def test_trials_equal_the_root_scripts(path):
    """The port draws the root script's trials from every search config
    (PyYAML's ``full_load`` for the root, ``read_config`` for the port)."""
    with open(path) as f:
        want = _trials(yaml.full_load(f), root_hs.sample_params)
    assert _trials(read_config(path), hs.sample_params) == want


# --- the CLI on the CPU, PyYAML blocked ---------------------------------------

def _config(tmp_path, **hyp):
    """``configs_hyp/synthetic_hyp_search.yaml`` (a CT search with noise
    ['off', endo]) with its logs under ``tmp_path`` and ``hyp`` /
    ``max_epochs`` changed, written as read_config reads it."""
    cfg = read_config(SYNTHETIC)
    cfg["logging_params"]["save_dir"] = str(tmp_path / "logs")
    cfg["trainer_params"]["max_epochs"] = hyp.pop("max_epochs", 1)
    cfg["hyperparameter_search"].update(hyp)
    path = tmp_path / "hyp.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _main(monkeypatch, path):
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    code = hs.main(["-c", path, "--device", "cpu"])
    with open(os.path.join(os.path.dirname(path), "logs", "CTMCQVAE",
                           "hyp_search", "results.json")) as f:
        return code, json.load(f)


def _root_trials(path):
    with open(path) as f:
        cfg = yaml.full_load(f)
    spec = cfg["hyperparameter_search"]["params"]
    return [root_hs._searched(t, spec)
            for t in _trials(cfg, root_hs.sample_params)]


def test_cli_fifo_end_to_end(tmp_path, monkeypatch, capsys):
    """fifo over the synthetic CT search's 3 trials (two with noise endo,
    one with two codebooks): every trial finite, the root script's
    parameters, the best the minimum, exit 0."""
    path = _config(tmp_path)
    want = _root_trials(path)
    code, results = _main(monkeypatch, path)
    assert code == 0 and "=== best ===" in capsys.readouterr().out
    assert {t["model_params.noise"] for t in want} == {"off", "endo"}
    trials = sorted(results["trials"], key=lambda t: t["trial"])
    assert [t["params"] for t in trials] == want
    assert all(math.isfinite(t["loss"]) for t in trials)
    assert results["best"]["loss"] == min(t["loss"] for t in trials)
    assert all(t["metrics"]["val_Reconstruction_Loss"] == t["loss"]
               for t in trials)


def test_cli_asha_end_to_end(tmp_path, monkeypatch, capsys):
    """asha, grace 1, eta 2, max_epochs 2: three trials train one epoch,
    the best one a second; one entry per trial."""
    path = _config(tmp_path, scheduler="asha", grace_period=1,
                   reduction_factor=2, max_epochs=2)
    code, results = _main(monkeypatch, path)
    out = capsys.readouterr().out
    assert code == 0 and "asha survivors" in out
    assert sorted(t["trial"] for t in results["trials"]) == [0, 1, 2]
    assert results["best"]["loss"] == min(t["loss"]
                                          for t in results["trials"])
    survivor = int(out.split("asha survivors (best first): [")[1][0])
    assert out.count(f"trial {survivor}: val_Reconstruction_Loss") == 2


def test_cli_asha_flags_a_late_crash(tmp_path, monkeypatch):
    """A trial that clears rung 1 and crashes at rung 2 is flagged failed
    with an infinite loss and cannot stay best."""
    path = _config(tmp_path, scheduler="asha", grace_period=1,
                   reduction_factor=2, num_samples=2, max_epochs=2)
    orig, first = hs.continue_trial, {}

    def crashing(trial, tid, target, cache, device):
        metrics = orig(trial, tid, target, cache, device)
        if target > 1:
            raise RuntimeError("late-rung crash")
        first[tid] = metrics["val_Reconstruction_Loss"]
        return metrics

    monkeypatch.setattr(hs, "continue_trial", crashing)
    code, results = _main(monkeypatch, path)
    winner = min(first, key=first.get)
    entry = {t["trial"]: t for t in results["trials"]}[winner]
    assert entry["loss"] == float("inf") and "late-rung crash" in entry[
        "failed"]
    assert results["best"] is None or results["best"]["trial"] != winner
    assert code == 0        # the other trial succeeded at rung 1


def test_cli_exits_non_zero_when_every_trial_fails(tmp_path, monkeypatch,
                                                   capsys):
    def failing(*args):
        raise RuntimeError("bad draw")

    monkeypatch.setattr(hs, "run_trial", failing)
    code, results = _main(monkeypatch, _config(tmp_path, num_samples=2))
    assert code == 1 and results["trials"] == []
    assert capsys.readouterr().out.count("failed: RuntimeError") == 2


def test_cli_reduction_factor_below_two_raises(tmp_path, monkeypatch):
    path = _config(tmp_path, scheduler="asha", reduction_factor=1)
    with pytest.raises(ValueError, match="reduction_factor"):
        _main(monkeypatch, path)


@pytest.mark.parametrize("scheduler", ["fifo", "asha"])
def test_cli_parallel_trials(tmp_path, monkeypatch, capsys, scheduler):
    """``parallel_trials: 2``: fifo runs each trial in a spawned process;
    asha runs each rung's trials so, each resuming from its ``last``
    checkpoint. Every trial reports, the best is the minimum, and under
    asha the survivor's checkpoint holds both epochs' steps."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    hyp = dict(num_samples=2, parallel_trials=2)
    if scheduler == "asha":
        hyp.update(scheduler="asha", grace_period=1, reduction_factor=2,
                   max_epochs=2)
    path = _config(tmp_path, **hyp)
    code, results = _main(monkeypatch, path)
    assert code == 0
    assert sorted(t["trial"] for t in results["trials"]) == [0, 1]
    assert all(math.isfinite(t["loss"]) for t in results["trials"])
    assert results["best"]["loss"] == min(t["loss"]
                                          for t in results["trials"])
    if scheduler == "asha":
        import torch
        assert "rung-parallel" in capsys.readouterr().out
        best = results["best"]["trial"]
        last = os.path.join(str(tmp_path), "logs", "CTMCQVAE", "hyp_search",
                            f"trial_{best}", "checkpoints", "last")
        blob = torch.load(last, map_location="cpu", weights_only=True)
        one_epoch = 3 * results["best"]["metrics"]["train_steps_base"]
        assert blob["step"] == 2 * one_epoch
