"""The ranks of ``tests/test_torch_parallel.py``: one process per rank of
a gloo group on the CPU, importing torch and the port and nothing of JAX
(so a rank starts in seconds).

    python tests/torch_dp_ranks.py <case> <rank> <world> <port> <payload>
        <out_dir>

``payload`` is a ``torch.save`` file the test wrote; each rank writes
``<out_dir>/rank<r>.pt``. The cases:

- ``steps``: for each model of the payload, its runs of train steps from
  its initial state on the rank's rows of each global batch; a step with
  recorded draws replays them (``ShardedDraws`` over ``ReplayDraws`` of
  the global draws); returns each step's metrics and gradients and the
  parameters and buffers after the run (``run_steps``, which the test
  also calls in one process on the global batches);
- ``fit``: ``VAEXperiment.fit`` of TSynthetic epochs: the rank's batches,
  the checkpoint files, a stop requested on one rank, a resume;
- ``misc``: the refusals under a world of 2 and ``dcn_replicas``.

``ReplayDraws`` and ``GammaSlot`` live here, free of JAX, and
``torch_port_common`` re-exports them.
"""

from __future__ import annotations

import copy
import os
import signal
import sys
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class GammaSlot:
    """A gamma draw recorded at trace time and filled when the program
    runs (so fetch the JAX results, which waits for it, before the
    replay)."""

    def __init__(self, shape):
        self.shape, self.value = tuple(shape), None


class ReplayDraws:
    """The port's draw provider, replaying a ``DrawRecorder``'s arrays."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        assert self.draws, f"port drew one more {kind} than JAX"
        k, a = self.draws.pop(0)
        if isinstance(a, GammaSlot):
            assert a.value is not None, "a gamma draw JAX never ran"
            a = a.value
        assert k == kind and a.shape == tuple(shape), (k, a.shape, kind,
                                                       tuple(shape))
        return torch.from_numpy(a.copy())

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, low, high, shape):
        return self._next("randint", shape)

    def cauchy(self, shape):
        return self._next("cauchy", shape)

    def gamma(self, alpha):
        return self._next("gamma", alpha.shape)

    def permutation(self, rows, n):
        return self._next("permutation", (rows, n))

    def done(self):
        return not self.draws


# --- steps ---------------------------------------------------------------------

def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def run_steps(spec: Dict[str, Any], group=None) -> List[Dict[str, Any]]:
    """The runs of ``spec`` (``cfg``, ``state_dict``, ``exp``, ``runs``:
    each a list of ``(mode, global batch, draws or None)`` steps from the
    initial state, with ``M_N`` and ``seed``) on the rank's rows of each
    batch (all of it without ``group``). Per run: each step's metrics and
    gradients, the parameters and buffers after it, the state's step."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import local_rows
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    model0 = build_model(dict(spec["cfg"]), device="cpu")
    model0.load_state_dict(spec["state_dict"])
    out = []
    for run in spec["runs"]:
        model = copy.deepcopy(model0)
        state = tstate.create_train_state(
            model, topt.build_optimizers(spec["exp"], model, 4),
            seed=run.get("seed", 0), group=group)
        state.step = run.get("step", 0)
        metrics, grads = [], []
        for mode, batch, draws in run["steps"]:
            if group is not None:
                batch = local_rows(batch, group)
            step_fn = tstate.make_train_step(mode, M_N=run.get("M_N", 1.0))
            if draws is None:
                m = step_fn(state, _tensors(batch))
            else:
                replay = ReplayDraws(draws)
                saved = tstate.Draws
                tstate.Draws = lambda gen, device: replay
                try:
                    m = step_fn(state, _tensors(batch))
                finally:
                    tstate.Draws = saved
                assert replay.done(), "the step drew fewer draws than JAX"
            metrics.append({k: v.clone() for k, v in m.items()})
            grads.append({n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None})
        out.append({"metrics": metrics, "grads": grads, "step": state.step,
                    "params": {n: p.detach().clone()
                               for n, p in model.named_parameters()},
                    "buffers": {n: b.clone()
                                for n, b in model.named_buffers()}})
    return out


def case_steps(payload, group) -> Dict[str, Any]:
    return {name: run_steps(spec, group)
            for name, spec in payload["models"].items()}


# --- fit -----------------------------------------------------------------------

def _experiment(payload, ckpt_dir: str, exp_extra=None):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    model = build_model(dict(payload["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(
                            payload["seed"]))
    data = VAEDataset(**payload["data"])
    data.setup()
    ckpt = CheckpointManager(ckpt_dir, top_k=2)
    exp = VAEXperiment(model, dict(payload["exp"], **(exp_extra or {})),
                       data, ckpt_manager=ckpt)
    exp.setup(seed=payload["seed"])
    return exp


def _params(exp) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in
            exp.model.state_dict().items()}


def case_fit(payload, group) -> Dict[str, Any]:
    from ctvae_torch.data import TransitionBatchScheduler
    from ctvae_torch.parallel import rank, world_size
    from ctvae_torch.training import install_preemption_handler
    out: Dict[str, Any] = {}
    root = payload["root"]
    exp = _experiment(payload, os.path.join(root, "run"))
    data = exp.data
    out["hosts"] = (data.host_id, data.num_hosts)
    # the rank's batches against the scheduler's slices of the global ones
    B = data.train_batch_size
    mine = TransitionBatchScheduler(
        data.train_dataset, batch_size=B, limit=data.limit, seed=data.seed,
        host_id=rank(), num_hosts=world_size())
    whole = TransitionBatchScheduler(
        data.train_dataset, batch_size=B * world_size(), limit=data.limit,
        seed=data.seed)
    slices = [(m, idx[rank() * B:(rank() + 1) * B])
              for m, idx in whole.epoch(0)]
    got = list(mine.epoch(0))
    out["slices_match"] = (len(got) == len(slices) > 0 and all(
        m == m2 and np.array_equal(i, i2)
        for (m, i), (m2, i2) in zip(got, slices)))
    seen = list(data.train_dataloader(0))
    out["batches_match"] = len(seen) == len(got) and all(
        b["mode"] == m and np.array_equal(
            b["image"], data.train_dataset.get_batch(i, m)["image"])
        for b, (m, i) in zip(seen, got))
    # one epoch; rank 0 alone writes
    saves: List[str] = []
    real_save = torch.save

    def spy(obj, f, *a, **k):
        saves.append(str(f))
        return real_save(obj, f, *a, **k)
    torch.save = spy
    try:
        exp.fit(1, seed=payload["seed"])
    finally:
        torch.save = real_save
    out["saves"] = saves
    out["writes"] = exp.ckpt.writes
    out["after_1"] = _params(exp)
    out["step_1"] = exp.global_step
    # a stop requested on rank 1 alone, during epoch 1: both stop there
    stop_rank = payload["stop_rank"]
    if rank() == stop_rank:
        train_epoch = exp.train_epoch

        def stopping(epoch):
            os.kill(os.getpid(), signal.SIGTERM)
            return train_epoch(epoch)
        exp.train_epoch = stopping
    exp.start_epoch = 1
    previous = install_preemption_handler(exp)
    try:
        exp.fit(3, seed=payload["seed"])
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    out["stopped_at"] = exp.global_step
    out["after_stop"] = _params(exp)
    # a resume from rank 0's file on every rank continues to epoch 3
    resumed = _experiment(payload, os.path.join(root, "run"))
    # setup's broadcast waited for rank 0, whose save is on disk
    out["last_after_stop"] = resumed.ckpt.restore("last")["step"]
    resumed.restore_full_state("last")
    out["resumed_from"] = (resumed.global_step, resumed.start_epoch)
    out["restored_equal"] = all(
        torch.equal(t, out["after_stop"][n])
        for n, t in _params(resumed).items())
    resumed.fit(3, seed=payload["seed"])
    out["resumed_end"] = resumed.global_step
    out["after_resume"] = _params(resumed)
    # the same three epochs without a stop
    straight = _experiment(payload, os.path.join(root, f"straight{rank()}"))
    straight.ckpt.writes = False
    straight.fit(3, seed=payload["seed"])
    out["straight"] = _params(straight)
    out["straight_end"] = straight.global_step
    return out


# --- misc: refusals and dcn_replicas -------------------------------------------

def _raises(fn, exc=NotImplementedError, text="ROADMAP A8") -> str:
    """'ok' when ``fn`` raises ``exc`` naming ``text``, else what it did."""
    try:
        fn()
    except exc as e:
        return "ok" if text in str(e) else f"message: {e}"
    except Exception as e:          # noqa: BLE001 - reported to the test
        return f"raised {type(e).__name__}: {e}"
    return "did not raise"


def case_misc(payload, group) -> Dict[str, Any]:
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import REPLICA_AXIS, DATA_AXIS, MODEL_AXIS
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    out: Dict[str, Any] = {"refused": {}, "accepted": {}}
    for name, cfg in payload["cross_batch"].items():
        model = build_model(dict(cfg), device="cpu")
        out["refused"][name] = _raises(lambda: VAEXperiment(model, {}, None))
    for name, cfg in payload["per_row"].items():
        model = build_model(dict(cfg), device="cpu")
        out["accepted"][name] = _raises(lambda: VAEXperiment(model, {}, None))
    ct = build_model(dict(payload["ct"]), device="cpu")
    for key, exp in (("fsdp", {"sharding": "fsdp"}),
                     ("sp", {"sharding": "sp"}),
                     ("model_axis", {"model_axis": 2})):
        out["refused"][key] = _raises(lambda: VAEXperiment(ct, exp, None))
    out["refused"]["seq_axis"] = _raises(lambda: build_model(
        dict(payload["ct"], seq_axis="model"), device="cpu"))
    state = tstate.create_train_state(
        ct, topt.build_optimizers({"LR": 1e-3}, ct, 4), group=group)
    stacked = {k: torch.from_numpy(np.stack([v, v]))
               for k, v in payload["batch"].items()}
    out["refused"]["scan_steps"] = _raises(
        lambda: tstate.make_multi_train_step("base", 2)(state, stacked))
    exp = VAEXperiment(ct, dict(payload["exp"], dcn_replicas=3), None)
    out["dcn_3"] = _raises(lambda: exp.setup(), ValueError, "dcn_replicas")

    # dcn_replicas 2 against plain dp: the mesh and three steps per mode
    results = {}
    for key, extra in (("dp", {}), ("dcn", {"dcn_replicas": 2})):
        model = build_model(dict(payload["ct"]), device="cpu")
        model.load_state_dict(payload["state_dict"])
        exp = VAEXperiment(model, dict(payload["exp"], **extra), None)
        exp.setup(seed=3)
        results[key + "_mesh"] = (tuple(exp.mesh.mesh_dim_names),
                                  tuple(exp.mesh.mesh.shape))
        for mode in ("base", "action", "causal"):
            for _ in range(2):
                exp._train_step(mode)(exp.state, _tensors(payload["batch"]))
        results[key] = {n: p.detach().clone()
                        for n, p in model.state_dict().items()}
    out["dp_mesh"] = results["dp_mesh"]
    out["dcn_mesh"] = results["dcn_mesh"]
    out["mesh_axes"] = (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS)
    out["dcn_equals_dp"] = all(torch.equal(t, results["dp"][n])
                               for n, t in results["dcn"].items())
    return out


CASES = {"steps": case_steps, "fit": case_fit, "misc": case_misc}


def main(argv: Optional[List[str]] = None) -> int:
    case, r, world, port, payload_path, out_dir = (argv or sys.argv[1:])
    torch.set_num_threads(1)
    from ctvae_torch.parallel import destroy, init_distributed
    group = init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             rank=int(r), world_size=int(world),
                             timeout_s=120)
    out_path = os.path.join(out_dir, f"rank{r}.pt")
    try:
        payload = torch.load(payload_path, weights_only=False)
        result = CASES[case](payload, group)
        torch.save({"ok": True, "result": result}, out_path)
    except BaseException:                   # reported to the test
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    # run the module's own copy: the payload's pickles name its classes
    # (GammaSlot) by the module, not by __main__
    import torch_dp_ranks
    sys.exit(torch_dp_ranks.main())
