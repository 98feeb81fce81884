"""Benchmark of the port on one card: the CT-MCQ-VAE train step of each
batch mode and the serving entry points.

    python -m ctvae_torch.bench [--config configs/ct_mcq_vae.yaml]
        [--blocks 5] [--block-steps 10] [--seed 0] [--device cpu]

The counterpart of the CT section of the JAX package's ``bench.py``
(``bench_ct_step`` and the ``*_scan8`` tier) and of its inference tier.
The model is the config's ``model_params`` (full width and depth) in
float32, trained with Adam at 5e-4 over every parameter and no schedule;
the JAX bench passes ``M_N = 0.00025``, which the CT-MCQ-VAE's loss does
not read. Images, ``input_y`` and one-hot actions are drawn from
``--seed`` on the device; no dataset is read.

Per train mode (base and action at ``BATCH`` = 128, causal at
``CAUSAL_BATCH`` = 16, so A*B = 192 in its virtual batch; the JAX
bench's batches):

* ``ct_<mode>_ms_per_step``: after 3 warm-up steps, ``--blocks`` blocks
  of ``--block-steps`` steps, each timed from the host clock to
  ``torch.cuda.synchronize()`` (the JAX bench's bounded queue); the
  median over blocks, per step;
* ``ct_<mode>_launches_per_step`` and ``ct_<mode>_device_ms_per_step``:
  the card's kernels, copies and fills in one ``torch.profiler`` step
  outside the timed blocks, and the sum of their durations (the time the
  card is busy in a step, without its idle gaps);
* ``ct_<mode>_ms_per_step_scan8``: the same timing through
  ``make_multi_train_step(mode, 8)`` (on the card, 8 replays of a
  captured CUDA graph per call; the JAX bench's ``lax.scan`` of 8 steps),
  after two warm-up calls, in blocks of ``--block-steps`` / 8 calls (at
  least one);
* ``ct_<mode>_step_mfu``: ``step_flops`` over ``ct_<mode>_ms_per_step``
  over the card's float32 peak: SMs x 128 lanes x 2 x its maximum SM
  clock, read on the card (``nvidia-smi --query-gpu=clocks.max.sm``).
  TF32 is off, so every product runs on those lanes.

Per serving entry point (``reconstruct``, ``encode``, ``apply_action``,
``classify_action``) at ``SERVE_BATCH`` = 16, ``serve_<entry>_ms``: ms
per request through ``serving/inference.py::make_inference_fn``, timed as
the train blocks.

Each timed block asserts a finite loss. Detail (per-block times, spreads,
the profiled steps' longest kernels, the card's name and power limit)
goes on earlier lines; the last line is one JSON object of at most 1,500
characters. Any failure raises, and the run exits non-zero. On the CPU
(``--device cpu``) the card's numbers (device ms, launches, mfu) are
null.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .config import read_section
from .models import build_model
from .ops.common import resolve_device
from .serving.inference import make_inference_fn
from .training import (build_optimizers, create_train_state,
                       make_multi_train_step, make_train_step)

MODES = ("base", "action", "causal")
BATCH = 128         # the base and action steps' batch
CAUSAL_BATCH = 16   # the causal step's batch (A*B in its virtual batch)
SERVE_BATCH = 16    # the serving requests' batch
SCAN_K = 8          # steps per make_multi_train_step call
SERVE_FNS = ("reconstruct", "encode", "apply_action", "classify_action")
LR = 5e-4
WARMUP_STEPS = 3
MAX_LINE = 1500

# operations per element of the pairwise-scores and GATv2 domains (fma =
# 2), as PERF.md's kernel table and chip_smoke.py's bounds count them:
# per (sample, source, target, hidden unit) or (sample, source, target,
# head, feature), forward and backward
PAIRWISE_OPS = (4, 5)
GAT_OPS = (9, 17)
GAT_LOGITS_OPS = (5, 10)


# --- the operation count ---------------------------------------------------

def _linear(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def _conv(n: int, side: int, cin: int, cout: int, k: int) -> int:
    """A convolution over ``n`` images whose output is side x side (for a
    transposed one: whose input is)."""
    return 2 * n * side * side * cin * cout * k * k


def _encoder(p: Dict, n: int) -> int:
    hd, s = list(p["hidden_dims"]), p["img_size"]
    total, fin = 0, p["in_channels"]
    for i, h in enumerate(hd):
        total += _conv(n, s >> (i + 1), fin, h, 4)
        fin = h
    side = s >> len(hd)
    total += _conv(n, side, fin, fin, 3)
    total += 6 * (_conv(n, side, fin, fin, 3) + _conv(n, side, fin, fin, 1))
    return total + _conv(n, side, fin, p["embedding_dim"], 1)


def _decoder(p: Dict, n: int) -> int:
    rev, side = list(p["hidden_dims"])[::-1], p["img_size"] >> len(
        p["hidden_dims"])
    total = _conv(n, side, p["embedding_dim"], rev[0], 3)
    total += 6 * (_conv(n, side, rev[0], rev[0], 3)
                  + _conv(n, side, rev[0], rev[0], 1))
    fin = rev[0]
    for i, h in enumerate(rev[1:] + [p["in_channels"]]):
        total += _conv(n, side << i, fin, h, 4)
        fin = h
    return total


def _ct(p: Dict, B: int, Bv: int, K: int, identity: bool, mask: bool):
    """(dense products, element operations) of the causal transition's
    forward and backward over a batch of ``B`` (discoverer 0) and a
    virtual batch of ``Bv`` (its intervention discoverer and the GAT)
    with ``K`` heads kept by the last GAT layer."""
    N, A = p["num_embeddings"], p["action_dim"]
    ld = list(p.get("causal_hidden_dims") or (800, 100))
    S = p.get("codebooks", 1) * (p["img_size"] >> len(p["hidden_dims"])) ** 2
    T, H, heads = S + 1, ld[0], 1 + A
    dense = 2 * _linear(B * S, N, H) + 2 * _linear(Bv * S, N, H)
    elem = sum(PAIRWISE_OPS) * (B + Bv) * S * S * H
    if mask:
        dense += _linear(Bv * S, A + N, N)
    dense += _linear(Bv, A, N)
    fin = N
    for d in ld[1:]:                    # hidden GAT layers, every head
        dense += 2 * _linear(Bv * T, fin, heads * d)
        elem += sum(GAT_OPS) * Bv * T * T * heads * d
        if identity:
            dense += _linear(B * S, fin, heads * d)
        fin = heads * d
    # the last layer: the kept heads' projections, logits and aggregation
    dense += 2 * _linear(Bv * T, fin, K * N) + 2 * Bv * T * T * K * N
    elem += sum(GAT_LOGITS_OPS) * Bv * T * T * K * N
    if identity:
        dense += _linear(B * S, fin, N)     # head 0 of the identity path
    return dense, elem


def step_flops(p: Dict, mode: str, B: int) -> int:
    """Operations (fma = 2) of one train step of ``mode`` at batch ``B``,
    counted from the config's shapes, not from what the kernels skip: the
    convolutions and linear layers; the last GAT layer's projections of
    the heads it keeps (K = 1 in base, 2 otherwise); every (source,
    target) pair of the pairwise and GAT domains at ``PAIRWISE_OPS``,
    ``GAT_OPS`` and ``GAT_LOGITS_OPS``. A dense product on the gradient's
    path costs its forward again twice in the backward; causal mode's
    encoder (only its code indices are used) has no backward. The VQ
    search, elementwise ops, losses and the optimizer are not counted."""
    if mode == "base":
        backbone = 3 * (_encoder(p, B) + _decoder(p, B))
        dense, elem = _ct(p, B, B, 1, identity=True, mask=False)
    elif mode == "action":
        backbone = 3 * (_encoder(p, 2 * B) + _decoder(p, B))
        dense, elem = _ct(p, B, B, 2, identity=False, mask=True)
    elif mode == "causal":
        backbone = _encoder(p, 2 * B)
        dense, elem = _ct(p, B, p["action_dim"] * B, 2, identity=False,
                          mask=True)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return backbone + 3 * dense + elem


# --- the card --------------------------------------------------------------

def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def f32_peak() -> float:
    """The card's float32 FLOP/s outside the tensor cores: SMs x 128
    lanes x 2 (an fma) x the maximum SM clock that ``nvidia-smi`` reads."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * 128 * 2 * mhz * 1e6
    print(f"f32 peak: {sms} SMs x 128 x 2 x {mhz:.0f} MHz = "
          f"{peak / 1e12:.3f} TFLOP/s", flush=True)
    return peak


# --- timing ----------------------------------------------------------------

class Timer:
    """Blocks of calls timed from the host clock to the device's end."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def blocks(self, label: str, fn: Callable[[], Optional[torch.Tensor]],
               blocks: int, calls: int, per_call: int = 1) -> float:
        """``blocks`` blocks of ``calls`` calls of ``fn``; each block's
        last result (a loss, or None) must be finite. Returns the median
        ms per unit (``per_call`` units a call)."""
        host = []
        for _ in range(blocks):
            self.sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                out = fn()
            self.sync()
            host.append(1e3 * (time.perf_counter() - t0)
                        / (calls * per_call))
            if out is not None and not math.isfinite(float(out)):
                raise AssertionError(f"{label}: loss {float(out)}")
        med = statistics.median(host)
        print(f"{label}: {med:.4f} ms per unit (median of {blocks} blocks "
              f"of {calls * per_call}; blocks "
              f"{json.dumps([round(t, 4) for t in host])}, spread "
              f"{max(host) - min(host):.4f})", flush=True)
        return med


def profiled_step(label: str, fn: Callable) -> Tuple[int, float]:
    """(launches, device ms): the card's kernels, copies and fills of one
    ``fn()`` call (warm) and the sum of their durations, with the longest
    kernels on detail lines."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # the card's work, without the profiler's ranges over it (such as
    # Adam.step's user annotation)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda r: -r[1])
    busy, n = sum(r[1] for r in rows), sum(r[2] for r in rows)
    print(f"profile {label}: {n} launches, device busy {busy:.3f} ms of "
          f"{wall:.3f} ms (profiled)", flush=True)
    for key, ms, count in rows[:6]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return n, busy


# --- the tiers -------------------------------------------------------------

def _inputs(p: Dict, B: int, device: torch.device, seed: int) -> Dict:
    gen = torch.Generator(device).manual_seed(seed)
    s, c, A = p["img_size"], p["in_channels"], p["action_dim"]
    action = torch.nn.functional.one_hot(
        torch.randint(0, A, (B,), generator=gen, device=device), A).float()
    return {"image": torch.rand(B, s, s, c, generator=gen, device=device),
            "input_y": torch.rand(B, s, s, c, generator=gen, device=device),
            "action": action}


def bench_train(p: Dict, mode: str, B: int, args, device: torch.device,
                timer: Timer) -> Dict:
    """The train step of ``mode`` at batch ``B``: eager blocks, one
    profiled step, then the multi-step tier on the same state."""
    model = build_model(p, device=device, generator=torch.Generator(
        device).manual_seed(args.seed))
    state = create_train_state(model, build_optimizers({"LR": LR}, model),
                               seed=args.seed)
    batch = _inputs(p, B, device, args.seed + 1)
    step = make_train_step(mode)
    for _ in range(WARMUP_STEPS):
        loss = step(state, batch)["loss"]
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{mode}: warm-up loss {float(loss)}")
    label = f"train {mode} B={B}"
    eager = timer.blocks(label, lambda: step(state, batch)["loss"],
                         args.blocks, args.block_steps)
    launches, device_ms = (profiled_step(label, lambda: step(state, batch))
                           if timer.cuda else (None, None))
    K = SCAN_K
    multi = make_multi_train_step(mode, K)
    stacked = {k: v.expand(K, *v.shape) for k, v in batch.items()}
    for _ in range(2):
        multi(state, stacked)
    scan = timer.blocks(f"{label} scan{K}",
                        lambda: multi(state, stacked)["loss"], args.blocks,
                        max(1, round(args.block_steps / K)), per_call=K)
    return {"ms": eager, "device_ms": device_ms, "launches": launches,
            "scan_ms": scan}


def bench_serve(p: Dict, B: int, args, device: torch.device,
                timer: Timer) -> Dict[str, float]:
    model = build_model(p, device=device, generator=torch.Generator(
        device).manual_seed(args.seed))
    x = _inputs(p, B, device, args.seed + 2)
    gen = torch.Generator(device).manual_seed(args.seed + 3)
    calls = {"reconstruct": lambda f: f(x["image"], generator=gen),
             "encode": lambda f: f(x["image"]),
             "apply_action": lambda f: f(x["image"], x["input_y"],
                                         x["action"], generator=gen),
             "classify_action": lambda f: f(x["image"], x["input_y"],
                                            generator=gen)}
    out = {}
    for name in SERVE_FNS:
        fn, call = make_inference_fn(model, name), calls[name]
        for _ in range(WARMUP_STEPS):
            y = call(fn)
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"serve {name}: non-finite output")
        out[name] = timer.blocks(f"serve {name} B={B}",
                                 lambda: call(fn).sum(), args.blocks,
                                 args.block_steps)
    return out


def _r(x: Optional[float], digits: int = 4) -> Optional[float]:
    return None if x is None else round(x, digits)


def run(args) -> Dict:
    """Every tier; returns the result line's object."""
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device available")
    p = read_section(args.config, "model_params")
    if p.get("name") != "CTMCQVAE":
        raise ValueError(f"{args.config}: the bench times a CTMCQVAE, got "
                         f"{p.get('name')!r}")
    timer = Timer(device)
    peak = None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(_smi("name,power.limit"), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
              f"TF32 off", flush=True)
        peak = f32_peak()
    result = {"device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu"),
              "config": args.config, "dtype": "float32"}
    batches = {"base": BATCH, "action": BATCH, "causal": CAUSAL_BATCH}
    for mode in MODES:
        B = batches[mode]
        r = bench_train(p, mode, B, args, device, timer)
        flops = step_flops(p, mode, B)
        mfu = (flops / (r["ms"] * 1e-3) / peak) if peak else None
        print(f"train {mode} B={B}: {flops / 1e9:.3f} GFLOP per step, mfu "
              f"{mfu}", flush=True)
        result.update({
            f"ct_{mode}_ms_per_step": _r(r["ms"]),
            f"ct_{mode}_ms_per_step_scan{SCAN_K}": _r(r["scan_ms"]),
            f"ct_{mode}_device_ms_per_step": _r(r["device_ms"]),
            f"ct_{mode}_launches_per_step": r["launches"],
            f"ct_{mode}_step_mfu": _r(mfu, 5)})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    result["ct_action_img_per_sec"] = _r(
        BATCH * 1e3 / result["ct_action_ms_per_step"], 1)
    serve = bench_serve(p, SERVE_BATCH, args, device, timer)
    result.update({f"serve_{k}_ms": _r(v) for k, v in serve.items()})
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="configs/ct_mcq_vae.yaml")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, which must exist)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--blocks", type=int, default=5,
                        help="timed blocks per tier (the median is kept)")
    parser.add_argument("--block-steps", type=int, default=10,
                        help="steps (requests) per timed block")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    result = run(args)
    print(f"bench wall time {time.perf_counter() - t0:.1f} s", flush=True)
    line = json.dumps(result)
    if len(line) > MAX_LINE:
        raise AssertionError(f"result line of {len(line)} characters, more "
                             f"than {MAX_LINE}")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
