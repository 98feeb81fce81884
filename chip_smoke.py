#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ctvae_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the seven CUDA kernels of ``ctvae_torch/csrc`` (four sources, one
``nvcc`` each, in parallel) and holds each against its plain PyTorch
version at the shapes of ``configs/ct_mcq_vae.yaml``: the four forward
kernels at the serving shapes, the three backward kernels (pairwise scores,
GATv2 attention, GATv2 per-head logits) against the plain versions'
autograd. Then it drives the port's three paths at that width, each with
the launch counters set to 0 just before and read just after:

* serving: ``reconstruct``, ``apply_action`` and ``classify_action`` at
  B = 16 (the causal virtual batch is A*B = 192), checked for shape, range
  and finiteness, and at B = 2 against the CPU plain path;
* training: train steps of each batch mode (base, action, causal) at
  B = 16 with the config's ``exp_params`` (``update_parameters:
  ct_layer``), checked for a finite loss, frozen parameters bit-unchanged,
  ``ct_layer`` moved, and every backward kernel launched in every mode;
* the two-stage recipe on TSynthetic (64x64, the headline widths with its
  8 actions): an MCQVAE pretrained for one epoch and saved, its weights
  restored alone into a CTMCQVAE, one ``VAEXperiment.fit`` epoch of
  ``ct_layer`` with checkpoints, a full-state resume into a fresh
  experiment, and ``apply_action`` (rollout, walk, navigate, causal
  sweep), with the bitwise checks of each stage.

Before that, ``VAEXperiment.fit`` runs one short epoch on TSynthetic at the
same widths (phase "loop"). The second-last line is one JSON
object with a row per kernel; the last line is ``{"ok": true, "device":
{...}}``. Any failed phase exits non-zero and prints no result; so does a
machine without a card. TF32 is off for matmuls and cuDNN convolutions, so
every number here is full float32.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
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
# exp_params of configs/ct_mcq_vae.yaml (tests/test_torch_training.py
# checks the two agree)
EXP_PARAMS = {
    "LR": 0.0005, "weight_decay": 0.0, "scheduler_gamma": 0.994,
    "kld_weight": 0.00025, "manual_seed": 1250,
    "update_parameters": "ct_layer",
}
# the loop phase: the headline widths on TSynthetic, whose grid has 4
# factors and so 8 actions (TShapes3D's 12 are not in the repo)
LOOP_MODEL_PARAMS = {**MODEL_PARAMS, "action_dim": 8}
BATCH = 16          # images per request / step (the config's batch sizes)
REQUESTS = 21       # calls per entry point; the first is the warm-up
TRAIN_STEPS = 6     # train steps per mode; the first is the warm-up
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores (every kernel here is f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# tolerances of kernel vs plain version (f32, sums in another order)
PAIRWISE_ATOL = 1e-5   # sigmoid outputs in (0, 1), 800-term sums
GAT_ATOL = 1e-4        # outputs ~1, softmax over 65 logits of ~10
# backward kernels: each gradient's max abs error over max(1, its max
# |value|); sums of up to 16 x 4096 terms (the shared dw2) in another order
GRAD_RTOL = 1e-4
VQ_TIE_RTOL = 1e-5     # index may differ only on a near-tie this close
SERVE_ATOL = 1e-4      # CUDA vs CPU serving outputs at B = 2
# per-head logits, forward and backward: max abs error over max(1, max
# |value|) of each output; sums of up to 64 (forward) and 192 x 65 x 65
# (the per-sample dwe / datt) f32 terms in another order
LOGITS_RTOL = 1e-5


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
        kernel = name
        for line in _build.build_log(name).splitlines():
            found = re.search(
                r"Compiling entry function '.*?([a-z][a-z_]*_kernel)", line)
            if found:
                kernel = found.group(1)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}.cu {kernel}: {line.strip()}")


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


def _gat_inputs(gen, B: int):
    """GAT attention inputs at the headline shapes (T = 64 sites + the
    action node, 13 heads of 100), an edgeless target at t = 7."""
    from ctvae_torch.ops.gat import replace_self_loops
    A = MODEL_PARAMS["action_dim"]
    T, H, F = 64 + 1, A + 1, 100
    xl = torch.randn(B, T, H, F, generator=gen, device="cuda")
    xr = torch.randn(B, T, H, F, generator=gen, device="cuda")
    we = torch.randn(H, F, generator=gen, device="cuda") * 0.1
    att = torch.randn(H, F, generator=gen, device="cuda") * 0.1
    raw = torch.rand(B, T, T, generator=gen, device="cuda")
    raw = raw * (torch.rand(B, T, T, generator=gen, device="cuda") < 0.5)
    adj, mask = replace_self_loops(raw)
    mask[:, :, 7] = False          # a target with no incoming edge
    return (xl, xr, adj.contiguous(), mask.contiguous(), we, att, 0.2)


def _check_gat(gen) -> dict:
    from ctvae_torch.ops import gat_flash as gf
    A = MODEL_PARAMS["action_dim"]
    args = _gat_inputs(gen, A * BATCH)
    xl, _, _, mask, _, _, _ = args
    B, T, H, F = xl.shape
    got, _ = gf.flash_gat_cuda(*args)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = gf.flash_gat_plain(*args)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    zero_row = bool((got[:, 7] == 0).all())
    ok = err <= GAT_ATOL and zero_row and bool(torch.isfinite(got).all())
    ms = time_ms(lambda: gf.flash_gat_cuda(*args))
    # the training forward also writes the f32 alpha residual [B,H,T,S]
    alpha_ms = time_ms(lambda: gf.flash_gat_cuda(*args, keep_alpha=True))
    plain = time_ms(lambda: gf.flash_gat_plain(*args), reps=5)
    edges = int(mask.sum())
    # per edge, head and feature: logit add, fma, leaky (2), fma; and the
    # aggregation's fma
    nbytes = 4 * (3 * B * T * H * F + B * T * T + 2 * H * F) + B * T * T
    bnd = bound_ms(nbytes, 9.0 * edges * H * F)
    row = {"name": "gat_fwd", "max_abs_err": err, "ok": ok, "ms": ms,
           "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
           "library_ms": None, "alpha_ms": alpha_ms,
           "note": f"B={B} T={T} H={H} F={F}, {edges} edges of {B * T * T}, "
                   f"edgeless target zero row: {zero_row}"}
    log(f"gat {row['note']}: max abs err {err:.3g}, max rel err "
        f"{rel:.3g}, kernel {ms:.4f} ms ({alpha_ms:.4f} ms writing alpha), "
        f"plain (full batch) {plain:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]})")
    return row


def _grad_errors(names, got, want):
    """(max abs error over the gradients, worst error / max(1, scale),
    text per gradient)."""
    worst, worst_rel, parts = 0.0, 0.0, []
    for name, g, w in zip(names, got, want):
        err = float((g - w).abs().max())
        rel = err / max(1.0, float(w.abs().max()))
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        parts.append(f"{name} {err:.3g} ({rel:.2g})")
        if not bool(torch.isfinite(g).all()):
            worst_rel = math.inf
    return worst, worst_rel, ", ".join(parts)


def _check_pairwise_bwd(gen) -> dict:
    """The backward kernel against the plain version's autograd: B = 16
    with shared params (discoverer 0) and A*B = 192 per sample (the
    causal path's action discoverers), S = T = 64, Hd = 800."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    S, Hd = 64, 800
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "pairwise_bwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None}
    notes = []
    for B, per_sample in ((BATCH, False), (A * BATCH, True)):
        pshape = (B, Hd) if per_sample else (Hd,)
        args = [torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5,
                torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5,
                torch.randn(pshape, generator=gen, device="cuda")
                / math.sqrt(Hd),
                torch.randn(pshape, generator=gen, device="cuda") * 0.1,
                torch.randn(pshape[:-1], generator=gen, device="cuda") * 0.1]
        dout = torch.randn(B, S, S, generator=gen, device="cuda")
        out = pf.flash_pairwise_cuda(*args, 0.01)
        kern = (args[0], args[1], args[2], args[3], out, dout, 0.01)
        leaves = [a.clone().requires_grad_() for a in args]
        got = torch.autograd.grad(pf.flash_pairwise(*leaves, 0.01), leaves,
                                  dout)
        plain_out = fused_pairwise_scores(*leaves, 0.01)
        want = torch.autograd.grad(plain_out, leaves, dout,
                                   retain_graph=True)
        torch.cuda.synchronize()
        err, rel, text = _grad_errors(("dxl", "dxr", "dw2", "db1", "db2"),
                                      got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= rel <= GRAD_RTOL
        ms = time_ms(lambda: pf.flash_pairwise_bwd_cuda(*kern))
        plain = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True), reps=5)
        del plain_out, want
        # per element: the add of pre, the slope's select and multiply,
        # the dxl and dxr adds, the dw2 fma (2)
        nbytes = 4 * (2 * (2 * B * S * Hd) + 2 * B * S * S
                      + 2 * (args[2].numel() + args[3].numel())
                      + args[4].numel())
        bnd = bound_ms(nbytes, 7.0 * B * S * S * Hd)
        notes.append(f"B={B} {'per-sample' if per_sample else 'shared'}: "
                     f"errors {text}; kernel {ms:.4f} ms, plain autograd "
                     f"{plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        # the row reports the causal call (A*B, per-sample): the largest
        row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1])
        torch.cuda.empty_cache()
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"pairwise_bwd {n}")
    return row


def _check_gat_bwd(gen) -> dict:
    """The backward kernel against the plain version's autograd at
    B = 16 (the plain version's temporaries at A*B = 192 take several
    4.2 GB tensors); the kernel is also timed at A*B = 192."""
    from ctvae_torch.ops import gat_flash as gf
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "gat_bwd", "library_ms": None}
    for B in (BATCH, A * BATCH):
        xl, xr, adj, mask, we, att, ns = _gat_inputs(gen, B)
        T, H, F = xr.shape[1:]
        dout = torch.randn(B, T, H, F, generator=gen, device="cuda")
        _, alpha = gf.flash_gat_cuda(xl, xr, adj, mask, we, att, ns,
                                     keep_alpha=True)
        kern = (xl, xr, adj, mask, we, att, alpha, dout, ns)
        ms = time_ms(lambda: gf.flash_gat_bwd_cuda(*kern))
        edges = int(mask.sum())
        # per edge, head and feature: pre (3), slope select and multiply,
        # the dxr add, the dadj, dwe, datt and dalpha fmas (2 each), the
        # dxl add and fma
        nbytes = 4 * (6 * B * T * H * F + 2 * B * T * T + B * H * T * T
                      + 4 * H * F) + B * T * T
        bnd = bound_ms(nbytes, 17.0 * edges * H * F)
        note = (f"B={B} T={T} H={H} F={F}, {edges} edges: kernel {ms:.4f} "
                f"ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if B == BATCH:
            leaves = [t.clone().requires_grad_()
                      for t in (xl, xr, adj, we, att)]

            def run(fn, retain=False):
                out = fn(leaves[0], leaves[1], leaves[2], mask, leaves[3],
                         leaves[4], ns)
                return out, torch.autograd.grad(out, leaves, dout,
                                                retain_graph=retain)
            _, got = run(gf.flash_gat)
            plain_out, want = run(gf.flash_gat_plain, retain=True)
            torch.cuda.synchronize()
            err, rel, text = _grad_errors(("dxl", "dxr", "dadj", "dwe",
                                           "datt"), got, want)
            no_grad_row = bool((got[1][:, 7] == 0).all())
            plain = time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, dout, retain_graph=True), reps=5)
            del plain_out, want
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1], max_abs_err=err,
                       ok=rel <= GRAD_RTOL and no_grad_row)
            note += (f", plain autograd {plain:.4f} ms; errors {text}; "
                     f"edgeless target gets no gradient: {no_grad_row}")
        else:
            row["ms_at_192"], row["bound_ms_at_192"] = ms, bnd[0]
        row["note"] = "; ".join(filter(None, [row.get("note"), note]))
        log(f"gat_bwd {note}")
        torch.cuda.empty_cache()
    return row


def _logits_inputs(gen, B: int, K: int, F: int, per_sample: bool):
    """Per-head logits inputs at S = T = 65 as ``heads_call`` gives them:
    a sampled 0/1 graph (edge probability 1/2) with its mean-filled
    self-loops, and an upstream gradient that is the masked softmax's VJP
    of a random one, so it is zero where the main path's is (no edge, or
    a target's only edge). Pre is exactly zero at (s, t) = (1, 2)
    (xr[b, 2] = -xl[b, 1], adj[b, 1, 2] = 0), a pair made live."""
    from ctvae_torch.ops.gat import masked_incoming_softmax, replace_self_loops
    S = T = 64 + 1
    xl = torch.randn(B, S, K, F, generator=gen, device="cuda")
    xr = torch.randn(B, T, K, F, generator=gen, device="cuda")
    xr[:, 2] = -xl[:, 1]
    pshape = (B, K, F) if per_sample else (K, F)
    we = torch.randn(pshape, generator=gen, device="cuda") * 0.1
    att = torch.randn(pshape, generator=gen, device="cuda") * 0.1
    graph = torch.rand(B, S, T, generator=gen, device="cuda") < 0.5
    adj, mask = replace_self_loops(graph.float())
    adj[:, 1, 2] = 0.0
    mask[:, 1, 2] = True
    logits = torch.randn(B, S, T, K, generator=gen, device="cuda",
                         requires_grad=True)
    alpha = masked_incoming_softmax(logits, mask)
    d_e, = torch.autograd.grad(alpha, logits, torch.randn(
        alpha.shape, generator=gen, device="cuda"))
    return (xl, xr, adj, we, att), d_e.contiguous()


def _logits_bwd_on_path(fn) -> dict:
    """The per-head logits backward as one call of ``fn`` (a train step)
    launches it: the share of pairs with a non-zero upstream gradient
    (the kernel skips the others, so its time depends on it), and the
    kernel's time and bound on those very inputs."""
    from ctvae_torch.ops import gat_logits as gl
    real, calls = gl.fused_gat_logits_bwd_cuda, []

    def probe(*args):
        calls.append(args)
        return real(*args)
    gl.fused_gat_logits_bwd_cuda = probe
    try:
        fn()
    finally:
        gl.fused_gat_logits_bwd_cuda = real
    (*args, d_e, ns), = calls
    live = int((d_e != 0).sum())
    bnd = bound_ms(_logits_bytes(args, d_e), 12.0 * live * args[0].shape[3])
    return {"live_share": live / d_e.numel(), "shape": list(d_e.shape),
            "ms": time_ms(lambda: real(*args, d_e, ns)), "bound_ms": bnd[0],
            "bound_by": bnd[1]}


# the causal step's call (the final GAT layer on the [A*B] virtual batch:
# head 0 and each sample's action head, F = N = 64) and bench_gat.py's
# shape (13 shared heads of 100)
LOGITS_SHAPES = ((MODEL_PARAMS["action_dim"] * BATCH, 2, 64, True),
                 (BATCH, MODEL_PARAMS["action_dim"] + 1, 100, False))


def _logits_bytes(args, d_e=None) -> int:
    """Each input read once, each output written once."""
    xl, xr, adj, we, att = args
    B, S, K, F = xl.shape
    T = xr.shape[1]
    ins = xl.numel() + xr.numel() + adj.numel() + we.numel() + att.numel()
    if d_e is None:
        return 4 * (ins + B * S * T * K)
    return 4 * (2 * ins + d_e.numel())


def _check_gat_logits(gen) -> dict:
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    row = {"name": "gat_logits_fwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None}
    notes = []
    for B, K, F, per_sample in LOGITS_SHAPES:
        args, _ = _logits_inputs(gen, B, K, F, per_sample)
        got = gl.fused_gat_logits_cuda(*args, 0.2)
        want = gat_logits(*args, 0.2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(1.0, float(want.abs().max()))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= rel <= LOGITS_RTOL and bool(torch.isfinite(got).all())
        ms = time_ms(lambda: gl.fused_gat_logits_cuda(*args, 0.2))
        plain = time_ms(lambda: gat_logits(*args, 0.2), reps=5)
        # per element of [B,S,T,K,F]: pre (add, multiply, add), the leaky
        # slope (multiply, select), the fma (2)
        bnd = bound_ms(_logits_bytes(args), 7.0 * got.numel() * F)
        notes.append(f"B={B} K={K} F={F} "
                     f"{'per-sample' if per_sample else 'shared'}: max abs "
                     f"err {err:.3g} ({rel:.2g} of scale), kernel {ms:.4f} "
                     f"ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
                     f"({bnd[1]})")
        if per_sample:   # the row reports the causal step's call
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1])
        del want
        torch.cuda.empty_cache()
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat_logits {n}")
    return row


def _check_gat_logits_bwd(gen) -> dict:
    """The backward kernel against the plain version's autograd at both
    shapes; two runs must agree bit for bit (no atomics)."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    row = {"name": "gat_logits_bwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None}
    notes = []
    for B, K, F, per_sample in LOGITS_SHAPES:
        args, d_e = _logits_inputs(gen, B, K, F, per_sample)
        got = gl.fused_gat_logits_bwd_cuda(*args, d_e, 0.2)
        again = gl.fused_gat_logits_bwd_cuda(*args, d_e, 0.2)
        leaves = [a.clone().requires_grad_() for a in args]
        plain_out = gat_logits(*leaves, 0.2)
        want = torch.autograd.grad(plain_out, leaves, d_e, retain_graph=True)
        torch.cuda.synchronize()
        err, rel, text = _grad_errors(("dxl", "dxr", "dadj", "dwe", "datt"),
                                      got, want)
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= rel <= LOGITS_RTOL and same
        ms = time_ms(lambda: gl.fused_gat_logits_bwd_cuda(*args, d_e, 0.2))
        plain = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, d_e, retain_graph=True), reps=5)
        del plain_out, want
        # what the VJP needs per element with a non-zero upstream gradient
        # (the kernel skips the rest), pre counted once: pre (3), the slope
        # select, the dxl and dxr adds, the dadj, dwe and datt fmas (2 each)
        live = int((d_e != 0).sum())
        bnd = bound_ms(_logits_bytes(args, d_e), 12.0 * live * F)
        notes.append(f"B={B} K={K} F={F} "
                     f"{'per-sample' if per_sample else 'shared'}, {live} "
                     f"of {d_e.numel()} pairs with a gradient: errors "
                     f"{text}; two runs bit-identical: {same}; kernel "
                     f"{ms:.4f} ms, plain autograd {plain:.4f} ms, bound "
                     f"{bnd[0]:.4f} ms ({bnd[1]})")
        if per_sample:
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1])
        torch.cuda.empty_cache()
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat_logits_bwd {n}")
    return row


def phase_kernels() -> list:
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [_check_vq(gen), _check_pairwise(gen), _check_pairwise_bwd(gen),
            _check_gat(gen), _check_gat_bwd(gen), _check_gat_logits(gen),
            _check_gat_logits_bwd(gen)]
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
    from ctvae_torch.ops import gat_flash, gat_logits, pairwise_flash, vq
    return {"vq_l2_argmin": vq.launches,
            "pairwise_fwd": pairwise_flash.launches,
            "pairwise_bwd": pairwise_flash.bwd_launches,
            "gat_fwd": gat_flash.launches,
            "gat_bwd": gat_flash.bwd_launches,
            "gat_logits_fwd": gat_logits.launches,
            "gat_logits_bwd": gat_logits.bwd_launches}


def _reset_counts() -> None:
    from ctvae_torch.ops import gat_flash, gat_logits, pairwise_flash, vq
    vq.launches = pairwise_flash.launches = gat_flash.launches = 0
    pairwise_flash.bwd_launches = gat_flash.bwd_launches = 0
    gat_logits.launches = gat_logits.bwd_launches = 0


# launches per request of each entry point (codebooks = 1)
_FWD = {"pairwise_fwd": 2, "pairwise_bwd": 0, "gat_fwd": 1, "gat_bwd": 0,
        "gat_logits_fwd": 1, "gat_logits_bwd": 0}
EXPECTED = {
    "reconstruct": {"vq_l2_argmin": 1, **_FWD},
    "apply_action": {"vq_l2_argmin": 2, **_FWD},
    "classify_action": {"vq_l2_argmin": 2, **_FWD},
}
# launches per train step of each batch mode
_TRAIN = {"pairwise_fwd": 2, "pairwise_bwd": 2, "gat_fwd": 1, "gat_bwd": 1,
          "gat_logits_fwd": 1, "gat_logits_bwd": 1}
EXPECTED_TRAIN = {
    "base": {"vq_l2_argmin": 1, **_TRAIN},
    "action": {"vq_l2_argmin": 2, **_TRAIN},
    "causal": {"vq_l2_argmin": 2, **_TRAIN},
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


def _profile(label: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the share of its wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile {label}: wall {wall:.3f} ms (profiled), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall), "
        f"{sum(r[2] for r in rows)} kernels")
    # the six longest, then the port's own kernels among the rest
    for i, (key, ms, count) in enumerate(rows):
        if i < 6 or re.search(r"namespace\)::(vq|pairwise|gat)_\w*kernel\(",
                              key):
            log(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")


def phase_profile(model) -> None:
    """One profiled request of each entry point."""
    from ctvae_torch.serving.inference import make_inference_fn
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 2), BATCH,
                        "cuda")
    args = {"reconstruct": (x,), "apply_action": (x, y, a),
            "classify_action": (x, y)}
    for name, call_args in args.items():
        fn = make_inference_fn(model, name)
        fn(*call_args)
        _profile(f"{name} B={BATCH}", lambda: fn(*call_args))


# --- phase 5: the training slice ------------------------------------------

def phase_train():
    """Train steps of each mode at the headline width, B = 16, with the
    config's exp_params; the launch counters are reset just before and
    read just after. Then one profiled step per mode."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    model = build_model(MODEL_PARAMS, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(
        model, build_optimizers(EXP_PARAMS, model, steps_per_epoch=100),
        seed=SEED)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 3), BATCH,
                        "cuda")
    batch = {"image": x, "input_y": y, "action": a}
    steps = {m: make_train_step(m) for m in EXPECTED_TRAIN}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    _reset_counts()
    for mode, step in steps.items():
        secs = []
        for _ in range(TRAIN_STEPS):
            c0 = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            c1 = _counts()
            got = {k: c1[k] - c0[k] for k in c1}
            if got != EXPECTED_TRAIN[mode]:
                raise AssertionError(f"train {mode}: launches per step {got}, "
                                     f"expected {EXPECTED_TRAIN[mode]}")
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"train {mode}: loss {loss}")
        timed = [1e3 * t for t in secs[1:]]
        timings[mode] = statistics.median(timed)
        log(f"train {mode} B={BATCH}: {timings[mode]:.3f} ms per step "
            f"(median of {len(timed)} after a warm-up; min {min(timed):.3f},"
            f" max {max(timed):.3f}); last loss {loss:.6g}, grad_norm "
            f"{float(metrics['grad_norm']):.6g}")
    launches = _counts()
    log(f"launches on the training path: {json.dumps(launches)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train: peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    prefix = EXP_PARAMS["update_parameters"]
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    stray = [n for n in moved if not n.startswith(prefix + ".")]
    if stray or not moved:
        raise AssertionError(f"update_parameters={prefix}: moved {moved}")
    n_ct = sum(1 for n, _ in model.named_parameters()
               if n.startswith(prefix + "."))
    log(f"train: {len(moved)} of {n_ct} {prefix} parameters moved, every "
        f"other parameter bit-unchanged")
    logits_bwd = {}
    for mode, step in steps.items():
        m = logits_bwd[mode] = _logits_bwd_on_path(lambda: step(state, batch))
        log(f"train {mode}: per-head logits backward d_e {m['shape']}, "
            f"{m['live_share']:.4f} of pairs with a gradient; kernel on "
            f"these inputs {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']})")
    for mode, step in steps.items():
        _profile(f"train step {mode} B={BATCH}",
                 lambda: step(state, batch))
    return timings, launches, peak, logits_bwd


# --- phase 6: the training loop -------------------------------------------

def phase_loop() -> dict:
    """``VAEXperiment.fit``: one short epoch on TSynthetic at 64x64 with
    the headline widths (8 actions), then validation."""
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    data = VAEDataset("", dataset_name="TSynthetic",
                      train_batch_size=BATCH, val_batch_size=BATCH,
                      patch_size=MODEL_PARAMS["img_size"], limit=48,
                      val_limit=BATCH, seed=SEED)
    data.setup()
    model = build_model(LOOP_MODEL_PARAMS, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    experiment = VAEXperiment(model, EXP_PARAMS, data)
    t0 = time.perf_counter()
    out = experiment.fit(1, seed=SEED)
    secs = time.perf_counter() - t0
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    mix = {m: int(out.get(f"train_steps_{m}", 0))
           for m in ("base", "action", "causal")}
    if bad or min(mix.values()) == 0:
        raise AssertionError(f"loop: non-finite {bad} or mode mix {mix}")
    log(f"loop: {experiment.global_step} train steps (mode mix "
        f"{json.dumps(mix)}) and validation in {secs:.2f} s; train loss "
        f"{out['train_loss']:.6g}, val loss {out['val_loss']:.6g}, "
        f"val causal_acc {out['val_causal_acc']:.4g}")
    return out


# --- phase 7: the two-stage recipe ---------------------------------------

def _valid_png(path: str) -> bool:
    """A PNG signature, chunks whose CRCs hold, an IHDR whose pixel data
    the IDAT decompresses to, and a closing IEND."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return False
    pos, chunks = 8, {}
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            return False
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    if pos != len(data) or b"IEND" not in chunks or b"IHDR" not in chunks:
        return False
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    return (depth == 8 and channels is not None and
            len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + w * channels))


def _state_equal(a, b) -> bool:
    """Two train states agree bit for bit: parameters, optimizer states
    (Adam moments and steps, schedule position), step and generator."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and torch.equal(x.cpu(),
                                                               y.cpu())
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    return same(a.state_dict(), b.state_dict())


def phase_two_stage() -> dict:
    """The two-stage CT recipe at the loop phase's widths (TSynthetic
    64x64, the headline widths, 8 actions, ``limit`` 48): pretrain an
    MCQVAE one epoch and save it; restore its weights only into a
    CTMCQVAE; ``fit`` one epoch of ``ct_layer`` with a checkpoint manager;
    resume the full state into a fresh experiment; ``apply_action``. Every
    check is bitwise. Returns the launches of the phase."""
    import tempfile
    from ctvae_torch.apply_action import apply_action
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager

    def model(params, seed):
        return build_model(params, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(seed))

    start = time.perf_counter()
    _reset_counts()
    data_params = dict(data_path="", dataset_name="TSynthetic",
                       train_batch_size=BATCH, val_batch_size=BATCH,
                       patch_size=MODEL_PARAMS["img_size"], limit=48,
                       val_limit=BATCH, seed=SEED)
    data = VAEDataset(**data_params)
    data.setup()
    with tempfile.TemporaryDirectory(prefix="ctvae_two_stage_") as tmp:
        # stage 1: the MCQVAE of the same widths, every parameter trained
        mp1 = {**{k: v for k, v in LOOP_MODEL_PARAMS.items()
                  if k not in ("action_dim", "causal_hidden_dims", "gamma")},
               "name": "MCQVAE"}
        exp1 = VAEXperiment(model(mp1, SEED), {
            k: v for k, v in EXP_PARAMS.items()
            if k != "update_parameters"}, data)
        exp1.setup(seed=SEED)
        pre = exp1.train_epoch(0)
        cm1 = CheckpointManager(os.path.join(tmp, "mcq"))
        cm1.save(exp1.state, exp1.global_step)
        stage1 = {n: t.clone() for n, t in exp1.model.state_dict().items()}
        del exp1

        # stage 2: weights-only restore, ct_layer alone trained
        ct = model(LOOP_MODEL_PARAMS, SEED + 1)
        fresh = {n: t.clone() for n, t in ct.state_dict().items()}
        cm2 = CheckpointManager(os.path.join(tmp, "ct"), top_k=2)
        exp = VAEXperiment(ct, EXP_PARAMS, data, ckpt_manager=cm2)
        exp.setup(seed=SEED)
        exp.load_weights(cm1.path("last"))
        is_ct = [n for n in fresh if n.startswith("ct_layer.")]
        backbone = [n for n in fresh if n not in is_ct]
        now = ct.state_dict()
        if set(backbone) != set(stage1) or not all(
                torch.equal(now[n], stage1[n]) for n in backbone):
            raise AssertionError("two_stage: backbone not restored")
        if not all(torch.equal(now[n], fresh[n]) for n in is_ct):
            raise AssertionError("two_stage: ct_layer lost its init")
        t0 = time.perf_counter()
        out = exp.fit(1, seed=SEED)
        fit_secs = time.perf_counter() - t0
        now = ct.state_dict()
        moved = [n for n in is_ct if not torch.equal(now[n], fresh[n])]
        if not all(torch.equal(now[n], stage1[n]) for n in backbone) \
                or not moved:
            raise AssertionError(f"two_stage: backbone changed or ct_layer "
                                 f"still ({len(moved)} moved)")
        if not math.isfinite(out["train_loss"]):
            raise AssertionError(f"two_stage: stage-2 loss {out}")
        step_ms = 1e3 * BATCH / out["train_images_per_sec"]

        # full-state resume into a fresh experiment (other init and seed)
        exp2 = VAEXperiment(model(LOOP_MODEL_PARAMS, SEED + 2), EXP_PARAMS,
                            data, ckpt_manager=cm2)
        exp2.setup(seed=SEED + 3)
        exp2.restore_full_state("last")
        if not (_state_equal(exp2.state, exp.state)
                and exp2.global_step == exp.global_step
                and exp2.start_epoch == 1):
            raise AssertionError("two_stage: full-state resume differs")
        with open(os.path.join(cm2.dir, "index.json")) as f:
            best = [os.path.basename(e["path"]) for e in json.load(f)["best"]]

        # apply_action on the stage-2 checkpoint
        config = {"model_params": LOOP_MODEL_PARAMS,
                  "data_params": data_params}
        res = apply_action(config, cm2.path("last"),
                           out=os.path.join(tmp, "images"), steps=2,
                           walk=(2, 3, 4), navigate=3, device="cuda")
        torch.cuda.synchronize()
        n_png = 1 + 2 * 2 * 4 + 2 * 3 + (3 + 2)
        bad = [p for p in res["images"] if not _valid_png(p)]
        if len(res["images"]) != n_png or bad or not (
                res["causal_batches"] and math.isfinite(res["causal_acc"])):
            raise AssertionError(f"two_stage: apply_action wrote "
                                 f"{len(res['images'])} PNGs of {n_png} "
                                 f"({len(bad)} invalid), sweep {res}")
    launches = _counts()
    secs = time.perf_counter() - start
    log(f"two_stage: MCQVAE pretrain {data.steps_per_epoch()} steps "
        f"(last recon loss {pre['Reconstruction_Loss']:.6g}); "
        f"weights-only restore: {len(backbone)} backbone tensors equal "
        f"stage 1's, {len(is_ct)} ct_layer tensors their init; stage-2 fit "
        f"{exp.global_step} steps + validation in {fit_secs:.2f} s "
        f"({step_ms:.3f} ms per train step, mean over the epoch), "
        f"{len(moved)} ct_layer tensors moved, backbone bit-unchanged; "
        f"checkpoints kept {best} + last; full-state resume bit-identical "
        f"(step {exp2.global_step}, start_epoch {exp2.start_epoch}, Adam "
        f"moments, generator)")
    log(f"two_stage: apply_action wrote {n_png} valid PNGs; causal sweep "
        f"{res['causal_acc']:.4f} ({res['causal_nodir_acc']:.4f} "
        f"undirected) over {res['causal_batches']} batches; phase "
        f"{secs:.2f} s")
    log(f"launches on the two_stage path: {json.dumps(launches)}")
    return launches


KERNEL_META = {
    "vq_l2_argmin": ("ctvae_torch/csrc/vq.cu", "ctvae_tpu/ops/vq.py:49"),
    "pairwise_fwd": ("ctvae_torch/csrc/pairwise.cu",
                     "ctvae_tpu/ops/pairwise_flash.py:64"),
    "pairwise_bwd": ("ctvae_torch/csrc/pairwise.cu",
                     "ctvae_tpu/ops/pairwise_flash.py:81"),
    "gat_fwd": ("ctvae_torch/csrc/gat.cu", "ctvae_tpu/ops/gat_flash.py:117"),
    "gat_bwd": ("ctvae_torch/csrc/gat.cu", "ctvae_tpu/ops/gat_flash.py:175"),
    "gat_logits_fwd": ("ctvae_torch/csrc/gat_logits.cu",
                       "scripts/bench_gat.py:76"),
    "gat_logits_bwd": ("ctvae_torch/csrc/gat_logits.cu",
                       "ctvae_tpu/ops/gat.py:85"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on a card",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    phase_card()
    phase_build()
    rows = phase_kernels()
    model, timings, serve_launches = phase_serve()
    phase_reference(model)
    phase_profile(model)
    del model
    train_ms, train_launches, peak, logits_bwd = phase_train()
    phase_loop()
    two_stage_launches = phase_two_stage()
    kernels = []
    for r in rows:
        source, replaces = KERNEL_META[r["name"]]
        by_path = {"serve": serve_launches[r["name"]],
                   "train": train_launches[r["name"]],
                   "two_stage": two_stage_launches[r["name"]]}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ok": r["ok"]})
        if r["name"] == "gat_logits_bwd":
            # its time depends on the live pairs: also on the causal
            # step's own inputs (``ms`` is at the check's sampled graph)
            kernels[-1]["on_causal_step"] = logits_bwd["causal"]
    # every kernel runs on the training and two-stage paths, the forward
    # ones on the serving path too
    if any(k["launches_by_path"][p] == 0 for k in kernels
           for p in ("train", "two_stage")) or any(
            k["launches_by_path"]["serve"] == 0 for k in kernels
            if EXPECTED["reconstruct"][k["name"]]):
        raise AssertionError("a kernel of a path was never launched")
    log(json.dumps({"serve_ms": timings, "train_ms": train_ms,
                    "train_peak_gib": peak}))
    log(f"chip_smoke wall time {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
