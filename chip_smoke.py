#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ctvae_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``ctvae_torch/csrc`` with ``nvcc``,
holds each against its plain PyTorch version at the serving shapes of
``configs/ct_mcq_vae.yaml``, then serves ``reconstruct``,
``apply_action`` and ``classify_action`` at that width (B = 16; the
causal virtual batch is A*B = 192) and checks that every request went
through every kernel. The served outputs are checked for shape, range and
finiteness, and at B = 2 against the same model's plain path on the CPU
(the path the CPU tests hold against the JAX package).

The second-last line is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result; so does a machine without a card. TF32 is off for
matmuls and cuDNN convolutions, so every number here is full float32.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# model_params of configs/ct_mcq_vae.yaml (the card's machine may have no
# PyYAML; tests/test_torch_serving.py checks the two agree)
MODEL_PARAMS = {
    "name": "CTMCQVAE", "in_channels": 3, "embedding_dim": 128,
    "action_dim": 12, "hidden_dims": [64, 128, 256], "num_embeddings": 64,
    "img_size": 64, "codebooks": 1, "beta": 0.1, "gamma": 1.5,
    "c_alpha": 0.01, "c_beta": 0.4, "c_delta": 0.01, "c_epsilon": 0.1,
    "noise": "off",
}
BATCH = 16          # images per request (the config's val_batch_size)
REQUESTS = 21       # calls per entry point; the first is the warm-up
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores (every kernel here is f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# tolerances of kernel vs plain version (f32, sums in another order)
PAIRWISE_ATOL = 1e-5   # sigmoid outputs in (0, 1), 800-term sums
GAT_ATOL = 1e-4        # outputs ~1, softmax over 65 logits of ~10
VQ_TIE_RTOL = 1e-5     # index may differ only on a near-tie this close
SERVE_ATOL = 1e-4      # CUDA vs CPU serving outputs at B = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 21) -> float:
    """Median device ms of one ``fn()`` call (CUDA events). Each sample
    times a run of back-to-back calls queued behind a device-side sleep,
    so the host's launch cost is hidden and the events read device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    inner = max(1, min(50, int(2e-3 / max(once, 1e-6))))
    # device-side sleep long enough to cover queueing ``inner`` calls
    # (~2e9 SM cycles per second), at most ~5 ms
    sleep_cycles = int(2e9 * min(1.5 * inner * once, 5e-3))
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def errors(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max abs error over max |want|). The relative error
    is taken against the output's scale, not elementwise: GAT outputs are
    sums of signed terms, and where they cancel to ~0 an elementwise
    ratio measures the cancellation, not the kernel."""
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 1: the card ----------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    log(f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


# --- phase 2: build -------------------------------------------------------

def phase_build() -> None:
    from ctvae_torch.ops import _build
    secs = _build.build_all()
    log(f"kernel build: {secs:.1f} s (nvcc, sm_90a, one process per source)")
    for name in _build.KERNELS:
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# --- phase 3: kernels against their plain versions ------------------------

def _check_vq(gen) -> dict:
    from ctvae_torch.ops import vq
    N, K, D = BATCH * 64, MODEL_PARAMS["num_embeddings"], \
        MODEL_PARAMS["embedding_dim"]
    x = torch.randn(N, D, generator=gen, device="cuda") * 0.3
    cb = (torch.rand(K, D, generator=gen, device="cuda") * 2 - 1) / K
    got = vq.l2_argmin_cuda(x, cb)
    want = vq.l2_argmin_plain(x, cb)
    torch.cuda.synchronize()
    dist = (x.double() ** 2).sum(1, keepdim=True) \
        + (cb.double() ** 2).sum(1) - 2 * x.double() @ cb.double().T
    d_got = dist.gather(1, got[:, None])[:, 0]
    d_want = dist.gather(1, want[:, None])[:, 0]
    gap = (d_got - d_want).abs()
    differ = got != want
    near_tie = gap <= VQ_TIE_RTOL * d_want.abs().clamp(min=1.0)
    bad = int((differ & ~near_tie).sum())
    row = {"name": "vq_l2_argmin", "max_abs_err": float(gap.max()),
           "ok": bad == 0,
           "note": f"{int(differ.sum())} of {N} indices differ, "
                   f"{int((differ & near_tie).sum())} of them near-ties "
                   f"(distance gap <= {VQ_TIE_RTOL} rel)"}
    row["ms"] = time_ms(lambda: vq.l2_argmin_cuda(x, cb))
    row["plain_ms"] = time_ms(lambda: vq.l2_argmin_plain(x, cb))
    row["library_ms"] = time_ms(lambda: torch.cdist(x, cb).argmin(1))
    row["bound_ms"], row["bound_by"] = bound_ms(
        4 * (N * D + K * D) + 8 * N, 2.0 * N * K * D)
    log(f"vq N={N} K={K} D={D}: {row['note']}; max distance gap "
        f"{row['max_abs_err']:.3g}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, cdist+argmin {row['library_ms']:.4f} ms")
    return row


def _check_pairwise(gen) -> dict:
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    S, Hd = 64, 800
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "pairwise_fwd", "max_abs_err": 0.0, "ok": True}
    notes = []
    for B, per_sample in ((BATCH, False), (A * BATCH, True)):
        xl = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
        xr = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
        pshape = (B, Hd) if per_sample else (Hd,)
        w2 = torch.randn(pshape, generator=gen, device="cuda") / math.sqrt(Hd)
        b1 = torch.randn(pshape, generator=gen, device="cuda") * 0.1
        b2 = torch.randn(pshape[:-1], generator=gen, device="cuda") * 0.1
        args = (xl, xr, w2, b1, b2, 0.01)
        got = pf.flash_pairwise_cuda(*args)
        want = fused_pairwise_scores(*args)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= err <= PAIRWISE_ATOL and bool(torch.isfinite(got).all())
        ms = time_ms(lambda: pf.flash_pairwise_cuda(*args))
        plain = time_ms(lambda: fused_pairwise_scores(*args), reps=5)
        elems = B * S * S * Hd
        # per element: add, leaky (mul, max), multiply-accumulate (2)
        bnd = bound_ms(4 * (2 * B * S * Hd + w2.numel() + b1.numel()
                            + b2.numel() + B * S * S), 5.0 * elems)
        notes.append(f"B={B} {'per-sample' if per_sample else 'shared'}: "
                     f"max abs err {err:.3g}, max rel err {rel:.3g}, "
                     f"kernel {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        # the row reports the causal call (A*B, per-sample): the largest
        row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1])
    row["library_ms"] = None
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"pairwise {n}")
    return row


def _check_gat(gen) -> dict:
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.gat import replace_self_loops
    A = MODEL_PARAMS["action_dim"]
    B, T, H, F = A * BATCH, 64 + 1, A + 1, 100
    xl = torch.randn(B, T, H, F, generator=gen, device="cuda")
    xr = torch.randn(B, T, H, F, generator=gen, device="cuda")
    we = torch.randn(H, F, generator=gen, device="cuda") * 0.1
    att = torch.randn(H, F, generator=gen, device="cuda") * 0.1
    raw = torch.rand(B, T, T, generator=gen, device="cuda")
    raw = raw * (torch.rand(B, T, T, generator=gen, device="cuda") < 0.5)
    adj, mask = replace_self_loops(raw)
    mask[:, :, 7] = False          # a target with no incoming edge
    args = (xl, xr, adj.contiguous(), mask.contiguous(), we, att, 0.2)
    got = gf.flash_gat_cuda(*args)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = gf.flash_gat_plain(*args)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    zero_row = bool((got[:, 7] == 0).all())
    ok = err <= GAT_ATOL and zero_row and bool(torch.isfinite(got).all())
    ms = time_ms(lambda: gf.flash_gat_cuda(*args))
    plain = time_ms(lambda: gf.flash_gat_plain(*args), reps=5)
    edges = int(mask.sum())
    # per edge, head and feature: logit add, fma, leaky (2), fma; and the
    # aggregation's fma
    nbytes = 4 * (3 * B * T * H * F + B * T * T + 2 * H * F) + B * T * T
    bnd = bound_ms(nbytes, 9.0 * edges * H * F)
    row = {"name": "gat_fwd", "max_abs_err": err, "ok": ok, "ms": ms,
           "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
           "library_ms": None,
           "note": f"B={B} T={T} H={H} F={F}, {edges} edges of {B * T * T}, "
                   f"edgeless target zero row: {zero_row}"}
    log(f"gat {row['note']}: max abs err {err:.3g}, max rel err "
        f"{rel:.3g}, kernel {ms:.4f} ms, "
        f"plain (full batch) {plain:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]})")
    return row


def phase_kernels() -> list:
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [_check_vq(gen), _check_pairwise(gen), _check_gat(gen)]
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return rows


# --- phase 4: the serving slice -------------------------------------------

def _requests(gen, B: int, device: str):
    s, A = MODEL_PARAMS["img_size"], MODEL_PARAMS["action_dim"]
    x = torch.rand(B, s, s, 3, generator=gen).to(device)
    y = torch.rand(B, s, s, 3, generator=gen).to(device)
    a = torch.nn.functional.one_hot(
        torch.randint(0, A, (B,), generator=gen), A).float().to(device)
    return x, y, a


def _counts():
    from ctvae_torch.ops import gat_flash, pairwise_flash, vq
    return {"vq_l2_argmin": vq.launches,
            "pairwise_fwd": pairwise_flash.launches,
            "gat_fwd": gat_flash.launches}


def _reset_counts() -> None:
    from ctvae_torch.ops import gat_flash, pairwise_flash, vq
    vq.launches = pairwise_flash.launches = gat_flash.launches = 0


# launches per request of each entry point (codebooks = 1)
EXPECTED = {
    "reconstruct": {"vq_l2_argmin": 1, "pairwise_fwd": 2, "gat_fwd": 1},
    "apply_action": {"vq_l2_argmin": 2, "pairwise_fwd": 2, "gat_fwd": 1},
    "classify_action": {"vq_l2_argmin": 2, "pairwise_fwd": 2, "gat_fwd": 1},
}


def _check_served(name: str, out: torch.Tensor, B: int) -> None:
    s, A = MODEL_PARAMS["img_size"], MODEL_PARAMS["action_dim"]
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output")
    if name == "classify_action":
        if tuple(out.shape) != (B, A):
            raise AssertionError(f"{name}: shape {tuple(out.shape)}")
        err = float((out.sum(-1) - 1).abs().max())
        if err > 1e-5:
            raise AssertionError(f"{name}: rows sum to 1 +- {err}")
    else:
        if tuple(out.shape) != (B, s, s, 3):
            raise AssertionError(f"{name}: shape {tuple(out.shape)}")
        if float(out.abs().max()) > 1.0:
            raise AssertionError(f"{name}: output outside [-1, 1]")


def phase_serve():
    from ctvae_torch.models import build_model
    from ctvae_torch.serving.inference import make_inference_fn
    t0 = time.perf_counter()
    model = build_model(MODEL_PARAMS, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"build_model on cuda: {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    fns = {n: make_inference_fn(model, n) for n in EXPECTED}
    gen = torch.Generator().manual_seed(SEED)
    x, y, a = _requests(gen, BATCH, "cuda")
    calls = {"reconstruct": lambda g: fns["reconstruct"](x, generator=g),
             "apply_action": lambda g: fns["apply_action"](x, y, a,
                                                           generator=g),
             "classify_action": lambda g: fns["classify_action"](
                 x, y, generator=g)}
    dgen = torch.Generator("cuda").manual_seed(SEED)
    timings = {}
    _reset_counts()
    for name, call in calls.items():
        secs = []
        for _ in range(REQUESTS):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(dgen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = _counts()
            step = {k: after[k] - before[k] for k in after}
            if step != EXPECTED[name]:
                raise AssertionError(f"{name}: launches per request {step}, "
                                     f"expected {EXPECTED[name]}")
            _check_served(name, out, BATCH)
        timed = [1e3 * t for t in secs[1:]]
        timings[name] = statistics.median(timed)
        log(f"serve {name} B={BATCH}: {timings[name]:.3f} ms per request "
            f"(median of {len(timed)} after a warm-up; min {min(timed):.3f}, "
            f"max {max(timed):.3f})")
    launches = _counts()
    log(f"launches on the serving path: {json.dumps(launches)}")
    return model, timings, launches


def _replay_draws(device, seed):
    """A ``Draws`` provider whose numbers come from a CPU generator, so a
    CUDA run and a CPU run of one seed get the same draws."""
    from ctvae_torch.models.base import Draws

    class CpuSeeded(Draws):
        def uniform(self, shape):
            return torch.rand(tuple(shape), generator=self.generator
                              ).to(self.device)

    return CpuSeeded(torch.Generator().manual_seed(seed), torch.device(device))


def phase_reference(model) -> None:
    """Each entry point at B = 2 on the card against the same weights on
    the CPU, where every op runs its plain version."""
    cpu_model = copy.deepcopy(model).to("cpu")
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 1), 2, "cpu")
    runs = {"reconstruct": dict(mode="base"),
            "apply_action": dict(mode="action", input_y=y, action=a),
            "classify_action": dict(mode="causal", input_y=y,
                                    action=torch.zeros_like(a))}
    for name, kw in runs.items():
        with torch.inference_mode():
            got = model(x.cuda(), draws=_replay_draws("cuda", SEED),
                        **{k: (v.cuda() if torch.is_tensor(v) else v)
                           for k, v in kw.items()})["recons"].cpu()
            want = cpu_model(x, draws=_replay_draws("cpu", SEED),
                             **kw)["recons"]
        err = float((got - want).abs().max())
        log(f"reference {name} B=2, card vs CPU plain path: max abs err "
            f"{err:.3g} (tolerance {SERVE_ATOL})")
        if not err <= SERVE_ATOL:
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


def phase_profile(model) -> None:
    """Device time by kernel over one request of each entry point, and the
    share of the request's wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    from ctvae_torch.serving.inference import make_inference_fn
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 2), BATCH,
                        "cuda")
    args = {"reconstruct": (x,), "apply_action": (x, y, a),
            "classify_action": (x, y)}
    for name, call_args in args.items():
        fn = make_inference_fn(model, name)
        fn(*call_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(*call_args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        log(f"profile {name} B={BATCH}: wall {wall:.3f} ms (profiled), "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall), "
            f"{sum(r[2] for r in rows)} kernels")
        for key, ms, count in rows[:6]:
            log(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")


KERNEL_META = {
    "vq_l2_argmin": ("ctvae_torch/csrc/vq.cu", "ctvae_tpu/ops/vq.py:49"),
    "pairwise_fwd": ("ctvae_torch/csrc/pairwise.cu",
                     "ctvae_tpu/ops/pairwise_flash.py:64"),
    "gat_fwd": ("ctvae_torch/csrc/gat.cu", "ctvae_tpu/ops/gat_flash.py:117"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on a card",
              file=sys.stderr)
        return 1
    phase_card()
    phase_build()
    rows = phase_kernels()
    model, timings, launches = phase_serve()
    phase_reference(model)
    phase_profile(model)
    kernels = []
    for r in rows:
        source, replaces = KERNEL_META[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ok": r["ok"]})
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError("a kernel of the path was never launched")
    log(json.dumps({"serve_ms": timings}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
