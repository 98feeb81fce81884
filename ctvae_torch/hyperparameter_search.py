"""Hyperparameter search of the port.

    python -m ctvae_torch.hyperparameter_search -c configs_hyp/<x>.yaml \\
        [--device cpu]

Counterpart of the JAX package's root ``hyperparameter_search.py``, with
its schema, its trials and its ``results.json``. The config is read
without PyYAML (``config.read_config``, ``!!python/tuple`` included). The
``hyperparameter_search.params`` tree names the searched keys with the
reference's ``to_tune`` rules: a list value becomes a choice, a tuple
value a uniform range. Trials are drawn with ``random.Random(exp_params.
manual_seed)``, so the port draws the trials the root script draws.

Each trial builds its model (``models.build_model``), data
(``data.VAEDataset``) and ``training.VAEXperiment`` on ``--device``
(``cuda`` unless given), seeded with ``manual_seed + trial_id``, and
reports its best ``val_Reconstruction_Loss``. Schedulers:

* ``fifo`` (default): each trial trains ``trainer_params.max_epochs``,
  one after the other or, with ``parallel_trials: N``, in N spawned
  processes;
* ``asha``: synchronous successive halving (``grace_period``,
  ``reduction_factor`` >= 2, default 2) up to ``max_epochs``. In one
  process trials pause between rungs with their state on the device and
  resume where they stopped; culled trials are released. With
  ``parallel_trials: N`` each rung's trials run in N spawned processes,
  each resuming the trial from its ``last`` checkpoint
  (``utils.checkpoint.CheckpointManager``).

A failed trial is printed with its ``repr`` and culled, and an entry it
made at an earlier rung is flagged ``failed`` with an infinite loss; the
run exits non-zero when no trial succeeded. Results go to
``<logging_params.save_dir>/<model_params.name>/hyp_search/results.json``
(``{"best": ..., "trials": [...]}``), rewritten after each report.
``resources_per_trial`` is read and ignored (a Ray Tune knob).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import random
import sys
from typing import Any, Dict, List, Optional


def sample_params(config: Dict[str, Any], spec: Any,
                  rng: random.Random) -> Dict[str, Any]:
    """One trial config drawn from the search space: ``spec`` dicts
    recurse into config sections, ``spec`` lists name keys of the current
    section; at each named leaf a list value -> ``rng.choice``, a tuple
    value -> ``rng.uniform(lo, hi)``. Keys missing from the config are
    skipped."""
    trial = copy.deepcopy(config)

    def walk(spec_node, cfg_node):
        if isinstance(spec_node, dict):
            for key, nested in spec_node.items():
                if key in cfg_node:
                    cfg_node[key] = walk(nested, cfg_node[key])
        elif isinstance(spec_node, list):
            for key in spec_node:
                if key in cfg_node:
                    cfg_node[key] = walk(None, cfg_node[key])
        else:
            if isinstance(cfg_node, tuple):
                return rng.uniform(cfg_node[0], cfg_node[1])
            if isinstance(cfg_node, list):
                return rng.choice(cfg_node)
        return cfg_node

    return walk(spec, trial)


def select_best(results):
    """The entry with the lowest finite ``loss`` (NaN and inf never win;
    with none, the first entry, or None for no entries)."""
    best = None
    for entry in results:
        loss = entry["loss"]
        if not math.isfinite(loss):
            continue
        if best is None or loss < best["loss"]:
            best = entry
    return best if best is not None else (results[0] if results else None)


def run_sha(num_trials: int, grace_period: int, reduction_factor: int,
            max_t: int, train_to, rung_runner=None, on_cull=None) -> list:
    """Synchronous successive halving over ``num_trials`` trials.

    ``train_to(trial_id, target_epochs) -> float | None`` trains the
    trial on up to ``target_epochs`` epochs in all and returns its
    objective (lower is better), or None when it failed. Rung budgets are
    ``grace_period * reduction_factor**i`` epochs, capped at ``max_t``;
    after each rung the best ``1/reduction_factor`` survive (at least
    one); failed trials are culled. Returns the trial ids alive after the
    last rung, best first. ``rung_runner(tids, budget) -> [(tid, loss |
    None)]``, when given, runs a whole rung instead of ``train_to``.
    ``on_cull(tids)`` gets the trials dropped at each rung boundary and,
    at the end, every trial still alive, so the caller can release
    them."""
    eta = max(2, int(reduction_factor))
    budget = max(1, int(grace_period))
    max_t = max(1, int(max_t))
    alive = list(range(num_trials))
    while True:
        budget = min(budget, max_t)
        if rung_runner is not None:
            outcomes = list(rung_runner(list(alive), budget))
        else:
            outcomes = [(tid, train_to(tid, budget)) for tid in alive]
        scores = []
        for tid, loss in outcomes:
            if loss is None:
                continue
            scores.append((loss if math.isfinite(loss) else float("inf"),
                           tid))
        scores.sort(key=lambda s: s[0])
        if budget >= max_t:
            if on_cull:
                on_cull(list(alive))
            return [tid for _, tid in scores]
        if not scores:
            return []
        survivors = [tid for _, tid in scores[:max(1, len(scores) // eta)]]
        if on_cull:
            culled = [tid for tid in alive if tid not in survivors]
            if culled:
                on_cull(culled)
        alive = survivors
        budget *= eta


def _searched(trial, spec):
    """The searched values of one trial, by dotted key."""
    out = {}

    def walk(spec_node, cfg_node, prefix):
        if isinstance(spec_node, dict):
            for key, nested in spec_node.items():
                walk(nested, cfg_node[key], prefix + (key,))
        elif isinstance(spec_node, list):
            for key in spec_node:
                out[".".join(prefix + (key,))] = cfg_node[key]
        else:
            out[".".join(prefix)] = cfg_node

    walk(spec, trial, ())
    return out


def _seed(trial_config: Dict[str, Any], trial_id: int) -> int:
    return int(trial_config["exp_params"].get("manual_seed", 0)) + trial_id


def _experiment(trial_config: Dict[str, Any], trial_id: int, device,
                ckpt_dir: Optional[str] = None):
    """The trial's ``VAEXperiment``: its model, data and train state
    seeded with ``manual_seed + trial_id``, the Trainer knobs
    ``gradient_clip_val`` / ``accumulate_grad_batches`` moved to the
    optimizer as ``run.py`` moves them, and a ``CheckpointManager`` (best
    one and ``last``) under ``ckpt_dir`` when given."""
    import torch

    from .data import VAEDataset
    from .models import build_model
    from .training import VAEXperiment
    from .utils.checkpoint import CheckpointManager

    seed = _seed(trial_config, trial_id)
    exp_params = dict(trial_config["exp_params"])
    trainer_params = trial_config.get("trainer_params", {})
    for knob in ("gradient_clip_val", "accumulate_grad_batches"):
        if trainer_params.get(knob) is not None:
            exp_params.setdefault(knob, trainer_params[knob])
    model = build_model(trial_config["model_params"], device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    data = VAEDataset(**{"seed": seed, **trial_config["data_params"]})
    data.setup()
    ckpt = (None if ckpt_dir is None else CheckpointManager(
        ckpt_dir, top_k=1, monitor="val_Reconstruction_Loss"))
    exp = VAEXperiment(model, exp_params, data, ckpt_manager=ckpt)
    exp.setup(seed=seed)
    return exp


def _floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _max_epochs(trial_config: Dict[str, Any]) -> int:
    return int(trial_config.get("trainer_params", {}).get("max_epochs", 10))


def run_trial(trial_config: Dict[str, Any], trial_id: int,
              device) -> Dict[str, float]:
    """Train one trial ``max_epochs`` epochs; its last metrics."""
    exp = _experiment(trial_config, trial_id, device)
    return _floats(exp.fit(_max_epochs(trial_config),
                           seed=_seed(trial_config, trial_id)))


def continue_trial(trial_config: Dict[str, Any], trial_id: int,
                   target_epochs: int, cache: Dict[int, Any], device):
    """Train trial ``trial_id`` on to ``target_epochs`` epochs in all,
    resuming its experiment from ``cache`` where the previous rung paused
    it (no epoch is trained twice). Returns its last metrics."""
    if trial_id not in cache:
        cache[trial_id] = [_experiment(trial_config, trial_id, device), 0,
                           {}]
    exp, epochs_done, last = cache[trial_id]
    if target_epochs <= epochs_done:
        return last
    exp.start_epoch = epochs_done
    metrics = _floats(exp.fit(target_epochs,
                              seed=_seed(trial_config, trial_id)))
    cache[trial_id][1:] = [target_epochs, metrics]
    return metrics


def _trial_entry(args):
    """One whole trial in a worker: (trial id, metrics or None, the
    error's ``repr`` or None)."""
    trial, trial_id, device = args
    try:
        return trial_id, run_trial(trial, trial_id, device), None
    except Exception as e:       # a bad draw must not stop the search
        return trial_id, None, repr(e)


def _rung_entry(args):
    """One trial's rung in a worker: it resumes the trial from its
    ``last`` checkpoint under ``ckpt_dir`` (written by the previous rung's
    ``fit``) and trains on to ``target_epochs``."""
    trial, trial_id, target_epochs, ckpt_dir, device = args
    try:
        exp = _experiment(trial, trial_id, device, ckpt_dir=ckpt_dir)
        if os.path.exists(os.path.join(ckpt_dir, "last")):
            exp.restore_full_state("last")
        if exp.start_epoch >= target_epochs:
            metrics = exp.validate(exp.start_epoch)
        else:
            metrics = exp.fit(target_epochs, seed=_seed(trial, trial_id))
        return trial_id, _floats(metrics), None
    except Exception as e:
        return trial_id, None, repr(e)


def _pool(parallel: int):
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=parallel,
                               mp_context=mp.get_context("spawn"))


def main(argv: Optional[List[str]] = None) -> int:
    """Run the search of a config file; returns the exit code (1 when
    every trial failed)."""
    parser = argparse.ArgumentParser(
        description="Hyperparameter search of the port's models")
    parser.add_argument("--config", "-c", dest="filename", metavar="FILE",
                        default="configs_hyp/ct_mcq_vae_hyp_search_shapes3d"
                                ".yaml")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, which must exist)")
    args = parser.parse_args(argv)

    from .config import read_config
    from .ops.common import resolve_device
    config = read_config(args.filename)
    device = str(resolve_device(args.device))

    hyp = config.pop("hyperparameter_search")
    num_samples = int(hyp.get("num_samples", 10))
    spec = hyp.get("params", {})
    parallel = int(hyp.get("parallel_trials", 1))
    rng = random.Random(int(config.get("exp_params", {}).get("manual_seed",
                                                             0)))
    save_dir = config.get("logging_params", {}).get("save_dir", "logs/")
    name = config.get("model_params", {}).get("name", "model")
    out_dir = os.path.join(save_dir, name, "hyp_search")
    os.makedirs(out_dir, exist_ok=True)

    trials = [sample_params(config, spec, rng) for _ in range(num_samples)]
    for tid, trial in enumerate(trials):
        print(f"--- trial {tid}/{num_samples}: {_searched(trial, spec)}",
              flush=True)
    if parallel > 1 and device.startswith("cuda"):
        # spawned workers would race on the build (its lock is a thread
        # lock): build every kernel here first
        from .ops import _build
        _build.build_all()

    results: List[Dict[str, Any]] = []

    def write_results():
        best = select_best(results)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump({"best": best, "trials": results}, f, indent=2,
                      default=str)
        return best

    def record(trial_id, metrics, err):
        if err is not None:
            print(f"    trial {trial_id} failed: {err}", flush=True)
            # an entry of an earlier rung must not stay competitive
            for r in results:
                if r["trial"] == trial_id:
                    r["loss"] = float("inf")
                    r["failed"] = err
            write_results()
            return
        loss = metrics.get("val_Reconstruction_Loss", float("inf"))
        # one entry per trial: the latest rung's
        results[:] = [r for r in results if r["trial"] != trial_id]
        results.append({"trial": trial_id, "loss": loss, "metrics": metrics,
                        "params": _searched(trials[trial_id], spec)})
        best = write_results()
        print(f"    trial {trial_id}: val_Reconstruction_Loss={loss:.5f} "
              f"(best={best['loss']:.5f} @ trial {best['trial']})",
              flush=True)

    scheduler = str(hyp.get("scheduler", "fifo")).lower()
    if scheduler in ("asha", "sha", "successive_halving"):
        grace = int(hyp.get("grace_period", 1))
        eta = int(hyp.get("reduction_factor", 2))
        if eta < 2:
            raise ValueError(
                f"hyperparameter_search.reduction_factor must be >= 2 (got "
                f"{eta}): successive halving keeps 1/eta of each rung")
        max_t = _max_epochs(config)
        cache: Dict[int, Any] = {}
        rung_runner = train_to = None
        if parallel > 1:
            print(f"--- scheduler: {scheduler} with rung-parallel "
                  f"evaluation ({parallel} processes; trials resume from "
                  f"checkpoints at each rung)", flush=True)

            def rung_runner(tids, budget):
                outcomes = []
                with _pool(parallel) as pool:
                    for tid, metrics, err in pool.map(_rung_entry, [
                            (trials[t], t, budget,
                             os.path.join(out_dir, f"trial_{t}",
                                          "checkpoints"), device)
                            for t in tids]):
                        record(tid, metrics, err)
                        outcomes.append((tid, None if metrics is None else
                                         metrics.get("val_Reconstruction_"
                                                     "Loss", float("inf"))))
                return outcomes
        else:
            def train_to(tid, epochs):
                try:
                    metrics = continue_trial(trials[tid], tid, epochs, cache,
                                             device)
                except Exception as e:  # a bad draw must not stop the search
                    record(tid, None, repr(e))
                    return None
                record(tid, metrics, None)
                return metrics.get("val_Reconstruction_Loss", float("inf"))

        def on_cull(tids):
            # release culled trials' state (parameters, Adam moments, data)
            for tid in tids:
                cache.pop(tid, None)
            if device.startswith("cuda"):
                import torch
                torch.cuda.empty_cache()

        survivors = run_sha(num_samples, grace, eta, max_t, train_to,
                            rung_runner=rung_runner, on_cull=on_cull)
        print(f"--- asha survivors (best first): {survivors}", flush=True)
    elif parallel > 1:
        with _pool(parallel) as pool:
            for tid, metrics, err in pool.map(
                    _trial_entry, [(t, i, device)
                                   for i, t in enumerate(trials)]):
                record(tid, metrics, err)
    else:
        for tid, trial in enumerate(trials):
            record(*_trial_entry((trial, tid, device)))

    best = write_results()
    print("=== best ===")
    print(json.dumps(best, indent=2, default=str), flush=True)
    if all("failed" in r for r in results):
        print("every trial failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
