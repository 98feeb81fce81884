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
  the pairwise backward is timed on each step's own two calls and held
  against the plain autograd on the causal step's;
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

    python3 chip_smoke.py --gat-fwd-against OTHER/gat.cu [...]

builds the kernels and only compares the tree's GAT forward with the
forward of other ``gat.cu`` files (an earlier commit's, or a variant):
outputs bit for bit, registers and occupancy, and times taken in turns
(``compare_gat_fwd``).

    python3 chip_smoke.py --pairwise-bwd-against OTHER/pairwise.cu [...]

does the same for the pairwise scores' backward, on dense inputs and on
the inputs each train mode's step gives it, with each build's error
against the plain autograd (``compare_pairwise_bwd``).

    python3 chip_smoke.py --pairwise-fwd-against OTHER/pairwise.cu [...]

and for the pairwise scores' forward, with each build's error against
the plain version (``compare_pairwise_fwd``).

    python3 chip_smoke.py --gat-logits-against OTHER/gat_logits.cu [...]

and for the GATv2 per-head logits, forward and backward, on the calls of
each train mode's step and on the check's inputs at A*B = 192 and B = 16
(``compare_gat_logits``).
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

def _ptxas(name: str, text: str) -> None:
    """Log the registers and spills ``ptxas -v`` reports per kernel."""
    kernel = name
    for line in text.splitlines():
        found = re.search(
            r"Compiling entry function '.*?([a-z][a-z_]*_kernel)", line)
        if found:
            kernel = found.group(1)
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name} {kernel}: {line.strip()}")


def phase_build() -> None:
    from ctvae_torch.ops import _build
    secs = _build.build_all()
    log(f"kernel build: {secs:.1f} s (nvcc, sm_90a, one process per source)")
    for name in _build.KERNELS:
        _build.load(name)
        _ptxas(f"{name}.cu", _build.build_log(name))


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


def _pairwise_fwd_bound(args):
    """Bytes: each input read once, the output written once. Operations:
    what the leaky split needs, relu(xl + xr') w2 per element (add, max,
    fma: 4, the 67 TFLOP/s peak counting an fma as two), the separable
    linear sums (per source and hidden unit an fma; per target and hidden
    unit the add of b1 and an fma), and per pair the linear part, b2 and
    the sigmoid (add, two fmas, negate, exp, add, divide: 8)."""
    xl, xr, w2, b1, b2, _ = args
    B, S, H = xl.shape
    T = xr.shape[1]
    nbytes = 4 * (xl.numel() + xr.numel() + w2.numel() + b1.numel()
                  + b2.numel() + B * S * T)
    ops = 4.0 * B * S * T * H + 2.0 * B * S * H + 3.0 * B * T * H \
        + 8.0 * B * S * T
    return bound_ms(nbytes, ops)


def _pairwise_fwd_inputs(gen, B: int, per_sample: bool):
    """The forward's arguments at S = T = 64, Hd = 800 (the headline
    discoverer): shared params at B = 16, per-sample ones at A*B = 192."""
    S, Hd = 64, 800
    xl = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
    xr = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
    pshape = (B, Hd) if per_sample else (Hd,)
    w2 = torch.randn(pshape, generator=gen, device="cuda") / math.sqrt(Hd)
    b1 = torch.randn(pshape, generator=gen, device="cuda") * 0.1
    b2 = torch.randn(pshape[:-1], generator=gen, device="cuda") * 0.1
    return (xl, xr, w2, b1, b2, 0.01)


def _pairwise_fwd_check(args) -> dict:
    """One forward call of the wrapper against the plain version on
    ``args``: the max abs error, whether a second call agrees bit for
    bit, the kernel's time and the bound."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores

    def fn(a):
        return pf.flash_pairwise_cuda(*a)
    with torch.no_grad():
        got, again = fn(args), fn(args)
        want = fused_pairwise_scores(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    res = {"shape": [*args[0].shape[:2], args[1].shape[1],
                     args[0].shape[2]],
           "per_sample": args[2].dim() == 2, "max_abs_err": err,
           "bit_identical": torch.equal(got, again),
           "ok": err <= PAIRWISE_ATOL and torch.equal(got, again)
           and bool(torch.isfinite(got).all())}
    del got, again, want
    res["ms"] = time_ms(lambda: fn(args))
    res["bound_ms"], res["bound_by"] = _pairwise_fwd_bound(args)
    return res


def _check_pairwise(gen) -> dict:
    """The forward kernel against the plain version at B = 16 with shared
    params (discoverer 0) and at A*B = 192 per sample (the causal path's
    action discoverers), which the row reports; two launches must agree
    bit for bit. Also logs the kernel's registers, local (spill) bytes,
    resident blocks per SM and the cluster that splits the hidden units."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "pairwise_fwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None, "occupancy": {}}
    notes = []
    for B, per_sample in ((BATCH, False), (A * BATCH, True)):
        args = _pairwise_fwd_inputs(gen, B, per_sample)
        m = _pairwise_fwd_check(args)
        plain = time_ms(lambda: fused_pairwise_scores(*args), reps=5)
        occ = pf.fwd_occupancy(B, 64, 64, 800)
        row["max_abs_err"] = max(row["max_abs_err"], m["max_abs_err"])
        row["ok"] &= m["ok"]
        notes.append(f"B={B} {'per-sample' if per_sample else 'shared'}: "
                     f"max abs err {m['max_abs_err']:.3g}, two launches "
                     f"bit-identical: {m['bit_identical']}, kernel "
                     f"{m['ms']:.4f} ms, plain {plain:.4f} ms, bound "
                     f"{m['bound_ms']:.4f} ms ({m['bound_by']}), "
                     f"{occ['cluster']} blocks per cluster")
        if B == BATCH:
            row["ms_at_16"], row["bound_ms_at_16"] = m["ms"], m["bound_ms"]
            row["plain_ms_at_16"] = plain
            row["occupancy"]["cluster_at_16"] = occ["cluster"]
        else:   # the row reports the causal call (A*B, per-sample)
            row.update(ms=m["ms"], plain_ms=plain, bound_ms=m["bound_ms"],
                       bound_by=m["bound_by"])
            row["occupancy"].update(occ)
        del args
        torch.cuda.empty_cache()
    occ = row["occupancy"]
    notes.append(f"{occ['regs']} registers, {occ['local_bytes']} local "
                 f"(spill) bytes per thread, {occ['warps']} warps, "
                 f"{occ['blocks_per_sm']} blocks per SM "
                 f"(pairwise_fwd_blocks_per_sm)")
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


def _gat_fwd_bound(args, keep_alpha: bool = False):
    """(ms, by) of the forward's bound on these inputs: each input read
    once, out (and alpha) written once, and the operations of the mask's
    edges."""
    xl, xr, adj, mask, we, att, _ = args
    B, S, H, F = xl.shape
    T = xr.shape[1]
    edges = int(mask.sum())
    nbytes = 4 * (xl.numel() + 2 * xr.numel() + adj.numel() + we.numel()
                  + att.numel() + (B * H * T * S if keep_alpha else 0)) \
        + mask.numel()
    # per edge, head and feature: logit add, fma, leaky (2), fma; and the
    # aggregation's fma
    return bound_ms(nbytes, 9.0 * edges * H * F)


def _check_gat(gen) -> dict:
    """The forward kernel against the plain version (out, and the alpha
    residual against the plain masked softmax) at B = 16, the serving shape
    of reconstruct / apply_action, and at A*B = 192, the causal call, which
    the row reports; two launches must agree bit for bit (out and alpha),
    and the serving launch (no alpha) with them. Also logs the kernel's
    registers, local (spill) bytes and resident blocks per SM."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.gat import gat_logits, masked_incoming_softmax
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "gat_fwd", "library_ms": None, "max_abs_err": 0.0,
           "ok": True}
    notes = []
    for B in (BATCH, A * BATCH):
        args = _gat_inputs(gen, B)
        xl, xr, adj, mask, we, att, ns = args
        T, H, F = xl.shape[1:]
        got, alpha = gf.flash_gat_cuda(*args, keep_alpha=True)
        again, alpha2 = gf.flash_gat_cuda(*args, keep_alpha=True)
        served, _ = gf.flash_gat_cuda(*args)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = gf.flash_gat_plain(*args)
            want_alpha = masked_incoming_softmax(
                gat_logits(xl, xr, adj, we, att, ns), mask).permute(0, 3, 2, 1)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        alpha_err = float((alpha - want_alpha).abs().max())
        same = (torch.equal(got, again) and torch.equal(alpha, alpha2)
                and torch.equal(got, served))
        zero_row = bool((got[:, 7] == 0).all())
        row["max_abs_err"] = max(row["max_abs_err"], err, alpha_err)
        row["ok"] &= (err <= GAT_ATOL and alpha_err <= GAT_ATOL and zero_row
                      and same and bool(torch.isfinite(got).all()))
        del got, again, served, alpha, alpha2, want, want_alpha
        ms = time_ms(lambda: gf.flash_gat_cuda(*args))
        # the training forward also writes the f32 alpha residual
        alpha_ms = time_ms(lambda: gf.flash_gat_cuda(*args, keep_alpha=True))
        plain = time_ms(lambda: gf.flash_gat_plain(*args), reps=5)
        edges = int(mask.sum())
        bnd = _gat_fwd_bound(args)
        notes.append(f"B={B} T={T} H={H} F={F}, {edges} edges of "
                     f"{B * T * T}: max abs err {err:.3g} (rel {rel:.3g}), "
                     f"alpha {alpha_err:.3g}; edgeless target zero row: "
                     f"{zero_row}; two launches and the serving launch "
                     f"bit-identical: {same}; kernel {ms:.4f} ms "
                     f"({alpha_ms:.4f} ms writing alpha), plain {plain:.4f} "
                     f"ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if B == BATCH:
            row["ms_at_16"], row["bound_ms_at_16"] = ms, bnd[0]
            row["plain_ms_at_16"] = plain
        else:   # the row reports the causal call (A*B = 192)
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1], alpha_ms=alpha_ms)
        del args
        torch.cuda.empty_cache()
    row["occupancy"] = gf.fwd_occupancy(T, T, F)
    notes.append(f"{row['occupancy']['regs']} registers, "
                 f"{row['occupancy']['local_bytes']} local (spill) bytes per "
                 f"thread, {row['occupancy']['warps']} warps, "
                 f"{row['occupancy']['blocks_per_sm']} blocks per SM "
                 f"(gat_fwd_blocks_per_sm)")
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat {n}")
    return row


def _grad_errors(names, got, want, own_scale: bool = False):
    """(max abs error over the gradients, worst error / max(1, scale),
    text per gradient). With ``own_scale`` each gradient's error is taken
    over its own scale max |want| instead (an all-zero ``want`` must be
    matched exactly), so gradients far below 1 are held as tightly as
    large ones; the text then gives each scale."""
    worst, worst_rel, parts = 0.0, 0.0, []
    for name, g, w in zip(names, got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        if not own_scale:
            rel = err / max(1.0, scale)
        else:
            rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        parts.append(f"{name} {err:.3g} " + (f"of {scale:.3g} " if own_scale
                                             else "") + f"({rel:.2g})")
        if not bool(torch.isfinite(g).all()):
            worst_rel = math.inf
    return worst, worst_rel, ", ".join(parts)


def _pairwise_bwd_inputs(gen, B: int, per_sample: bool):
    """The backward's arguments (xl, xr, w2, b1, out, dout, ns) at S = T =
    64, Hd = 800 with a dense upstream gradient, and b2."""
    from ctvae_torch.ops import pairwise_flash as pf
    S, Hd = 64, 800
    pshape = (B, Hd) if per_sample else (Hd,)
    xl = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
    xr = torch.randn(B, S, Hd, generator=gen, device="cuda") * 0.5
    w2 = torch.randn(pshape, generator=gen, device="cuda") / math.sqrt(Hd)
    b1 = torch.randn(pshape, generator=gen, device="cuda") * 0.1
    b2 = torch.randn(pshape[:-1], generator=gen, device="cuda") * 0.1
    dout = torch.randn(B, S, S, generator=gen, device="cuda")
    out = pf.flash_pairwise_cuda(xl, xr, w2, b1, b2, 0.01)
    return (xl, xr, w2, b1, out, dout, 0.01), b2


def _pairwise_bwd_bound(args, live_pairs: int):
    """Bytes: each input read once (xl, xr, w2, b1, out, dout), each
    gradient written once in its param's shape. Operations: what the
    algorithm needs, with dw2 = sum_s xl sum_t g + sum_t xr sum_s g + b1
    sum g taken from the separable sums: per live pair (a non-zero dz; the
    rest add nothing) and hidden unit, the add of pre, the slope's test and
    select and the sum_t g and sum_s g adds (5); per (source or target,
    hidden unit) the dxl or dxr multiply and a dw2 fma (3: the 67 TFLOP/s
    peak counts an fma as two operations); per sample and hidden unit the
    db1 multiply and the b1 fma (3); per pair dz = dout out (1 - out) and
    ns dz (4)."""
    xl, xr, w2, b1, out, dout, _ = args
    B, S, H = xl.shape
    T = xr.shape[1]
    nb2 = B if w2.dim() == 2 else 1
    nbytes = 4 * (2 * (xl.numel() + xr.numel() + w2.numel() + b1.numel())
                  + out.numel() + dout.numel() + nb2)
    ops = 5.0 * live_pairs * H + 3.0 * B * (S + T + 1) * H + 4.0 * B * S * T
    return bound_ms(nbytes, ops)


def _pairwise_live(args) -> dict:
    """What of dz = dout out (1 - out) is non-zero: the shares of its rows
    (source s of a sample), of the rows' 8-target segments and of its
    pairs, and the count of live pairs."""
    out, dout = args[4], args[5]
    dz = dout * out * (1 - out)
    B, S, T = dz.shape
    live = dz != 0
    segs = torch.nn.functional.pad(live.to(torch.int8), (0, -T % 8)
                                   ).view(B, S, -1, 8)
    pairs = int(live.sum())
    return {"shape": [B, S, T, args[0].shape[2]],
            "live_rows": float(live.any(2).float().mean()),
            "live_segments": float(segs.any(3).float().mean()),
            "live_pairs": pairs / live.numel(), "pairs": pairs}


def _pairwise_plain_grads(args) -> list:
    """The plain version's autograd from the kernel's own residual ``out``:
    the gradients of the logits z = sum_h leaky(pre) w2 against dz = dout
    out (1 - out), what the sigmoid's backward hands them; dw2, db1 and
    db2 folded into their param's shape."""
    from ctvae_torch.ops.pairwise import _bh
    xl, xr, w2, b1, out, dout, ns = args
    out, dout = out.detach(), dout.detach()
    leaves = [t.detach().clone().requires_grad_() for t in (xl, xr, w2, b1)]
    pre = leaves[0][:, :, None, :] + leaves[1][:, None, :, :] \
        + _bh(leaves[3])
    z = torch.sum(torch.where(pre >= 0, pre, ns * pre) * _bh(leaves[2]), -1)
    dz = dout * out * (1 - out)
    grads = list(torch.autograd.grad(z, leaves, dz))
    del pre, z
    return grads + [dz.sum((1, 2)) if w2.dim() == 2 else dz.sum()]


def _pairwise_folded(grads, args) -> list:
    """The kernel's per-sample dw2, db1, db2 folded as its caller folds
    them (summed over the batch for a shared param)."""
    from ctvae_torch.ops.pairwise_flash import _fold
    w2 = args[2]
    return [grads[0], grads[1], _fold(grads[2], w2), _fold(grads[3], w2),
            grads[4] if w2.dim() == 2 else grads[4].sum()]


def _check_pairwise_bwd(gen) -> dict:
    """The backward kernel against the plain version's autograd: B = 16
    with shared params (discoverer 0) and A*B = 192 per sample (the
    causal path's action discoverers), S = T = 64, Hd = 800, a dense
    upstream gradient; two runs must agree bit for bit (no atomics). Also
    logs the kernel's registers, local (spill) bytes and resident blocks
    per SM."""
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "pairwise_bwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None}
    notes = []
    for B, per_sample in ((BATCH, False), (A * BATCH, True)):
        kern, b2 = _pairwise_bwd_inputs(gen, B, per_sample)
        args = list(kern[:4]) + [b2]
        dout = kern[5]
        leaves = [a.clone().requires_grad_() for a in args]
        got = torch.autograd.grad(pf.flash_pairwise(*leaves, 0.01), leaves,
                                  dout)
        again = torch.autograd.grad(pf.flash_pairwise(*leaves, 0.01),
                                    leaves, dout)
        plain_out = fused_pairwise_scores(*leaves, 0.01)
        want = torch.autograd.grad(plain_out, leaves, dout,
                                   retain_graph=True)
        torch.cuda.synchronize()
        err, rel, text = _grad_errors(("dxl", "dxr", "dw2", "db1", "db2"),
                                      got, want, own_scale=True)
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= rel <= GRAD_RTOL and same
        del got, again
        ms = time_ms(lambda: pf.flash_pairwise_bwd_cuda(*kern))
        plain = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True), reps=5)
        del plain_out, want
        bnd = _pairwise_bwd_bound(kern, _pairwise_live(kern)["pairs"])
        notes.append(f"B={B} {'per-sample' if per_sample else 'shared'}: "
                     f"errors {text}; two runs bit-identical: {same}; "
                     f"kernel {ms:.4f} ms, plain autograd {plain:.4f} ms, "
                     f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if B == BATCH:
            row["ms_at_16"], row["bound_ms_at_16"] = ms, bnd[0]
            row["plain_ms_at_16"] = plain
        else:   # the row reports the causal call (A*B = 192)
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1])
        del kern, args, leaves
        torch.cuda.empty_cache()
    occ = row["occupancy"] = pf.bwd_occupancy(64, 64)
    notes.append(f"{occ['regs']} registers, {occ['local_bytes']} local "
                 f"(spill) bytes per thread, {occ['warps']} warps, "
                 f"{occ['blocks_per_sm']} blocks per SM "
                 f"(pairwise_bwd_blocks_per_sm)")
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"pairwise_bwd {n}")
    return row


def _gat_bwd_plain(args, dout, chunk: int):
    """The plain version's autograd gradients, in chunks of ``chunk``
    samples (at A*B = 192 whole, its temporaries take several 4.2 GB
    tensors): dxl, dxr and dadj are per sample and concatenate, dwe and
    datt sum over the batch. Returns (gradients, ms of the backward calls
    summed over the chunks)."""
    from ctvae_torch.ops.gat_flash import flash_gat_plain
    xl, xr, adj, mask, we, att, ns = args
    parts, ms = [], 0.0
    for c in range(0, xl.shape[0], chunk):
        leaves = [t[c:c + chunk].clone().requires_grad_()
                  for t in (xl, xr, adj)]
        leaves += [we.clone().requires_grad_(), att.clone().requires_grad_()]
        out = flash_gat_plain(leaves[0], leaves[1], leaves[2],
                              mask[c:c + chunk], leaves[3], leaves[4], ns)
        d = dout[c:c + chunk]
        parts.append(torch.autograd.grad(out, leaves, d, retain_graph=True))
        ms += time_ms(lambda: torch.autograd.grad(out, leaves, d,
                                                  retain_graph=True), reps=5)
        del out
    grads = [torch.cat([p[i] for p in parts]) for i in range(3)]
    grads += [sum(p[i] for p in parts) for i in (3, 4)]
    return grads, ms


def _check_gat_bwd(gen) -> dict:
    """The backward kernel (through ``FlashGAT``) against the plain
    version's autograd at B = 16 and at A*B = 192, the causal call, which
    the row reports (the plain version there in 12 chunks of 16); two runs
    must agree bit for bit (no atomics). Also logs the kernel's registers,
    local (spill) bytes and resident blocks per SM."""
    from ctvae_torch.ops import gat_flash as gf
    A = MODEL_PARAMS["action_dim"]
    row = {"name": "gat_bwd", "library_ms": None, "max_abs_err": 0.0,
           "ok": True}
    notes = []
    for B in (BATCH, A * BATCH):
        args = _gat_inputs(gen, B)
        xl, xr, adj, mask, we, att, ns = args
        T, H, F = xr.shape[1:]
        dout = torch.randn(B, T, H, F, generator=gen, device="cuda")

        def run():
            leaves = [t.clone().requires_grad_()
                      for t in (xl, xr, adj, we, att)]
            out = gf.flash_gat(leaves[0], leaves[1], leaves[2], mask,
                               leaves[3], leaves[4], ns)
            return torch.autograd.grad(out, leaves, dout)
        got, again = run(), run()
        want, plain = _gat_bwd_plain(args, dout, BATCH)
        torch.cuda.synchronize()
        err, rel, text = _grad_errors(("dxl", "dxr", "dadj", "dwe", "datt"),
                                      got, want)
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        no_grad_row = bool((got[1][:, 7] == 0).all())
        del got, again, want
        _, alpha = gf.flash_gat_cuda(*args, keep_alpha=True)
        ms = time_ms(lambda: gf.flash_gat_bwd_cuda(
            xl, xr, adj, mask, we, att, alpha, dout, ns))
        edges = int(mask.sum())
        # per edge, head and feature: pre (3), slope select and multiply,
        # the dxr add, the dadj, dwe, datt and dalpha fmas (2 each), the
        # dxl add and fma
        nbytes = 4 * (6 * B * T * H * F + 2 * B * T * T + B * H * T * T
                      + 4 * H * F) + B * T * T
        bnd = bound_ms(nbytes, 17.0 * edges * H * F)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ok"] &= rel <= GRAD_RTOL and same and no_grad_row
        chunks = f" ({B // BATCH} chunks of {BATCH})" if B > BATCH else ""
        notes.append(f"B={B} T={T} H={H} F={F}, {edges} edges: errors "
                     f"{text}; two runs bit-identical: {same}; edgeless "
                     f"target gets no gradient: {no_grad_row}; kernel "
                     f"{ms:.4f} ms, plain autograd {plain:.4f} ms{chunks}, "
                     f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if B == BATCH:
            row["ms_at_16"], row["bound_ms_at_16"] = ms, bnd[0]
            row["plain_ms_at_16"] = plain
        else:   # the row reports the causal call (A*B = 192)
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                       bound_by=bnd[1])
        del alpha
        torch.cuda.empty_cache()
    occ = row["occupancy"] = gf.bwd_occupancy(T, T, F)
    notes.append(f"{occ['regs']} registers, {occ['local_bytes']} local "
                 f"(spill) bytes per thread, {occ['warps']} warps, "
                 f"{occ['blocks_per_sm']} blocks per SM "
                 f"(gat_bwd_blocks_per_sm)")
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat_bwd {n}")
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


def _calls_of(module, name: str, fn) -> list:
    """The (args, kwargs) of each call of ``module.name`` while ``fn()``
    runs."""
    real, calls = getattr(module, name), []

    def probe(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    setattr(module, name, probe)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return calls


def _pairwise_bwd_on_path(fn, check: bool = False) -> dict:
    """The pairwise backward as one call of ``fn`` (a train step) launches
    it, for each of its two calls ("no_inter": discoverer 0, shared params;
    "inter": the intervention discoverers, per sample): the shape, the
    live shares of dz (the kernel skips dead rows and segments, so its
    time depends on them), and the kernel's time and bound (live pairs
    only) on those very inputs. With ``check``, the gradients against the
    plain version's autograd (``err``: the worst error over its gradient's
    own scale, held to GRAD_RTOL), and the same error of a control that
    must fail the limit: the plain gradients with the slope 1 everywhere
    (``control_err``)."""
    from ctvae_torch.ops import pairwise_flash as pf
    res = {}
    for args, _ in _calls_of(pf, "flash_pairwise_bwd_cuda", fn):
        m = res["no_inter" if args[2].dim() == 1 else "inter"] = \
            _pairwise_live(args)
        m["ms"] = time_ms(lambda: pf.flash_pairwise_bwd_cuda(*args))
        m["bound_ms"], m["bound_by"] = _pairwise_bwd_bound(args, m["pairs"])
        if check:
            names = ("dxl", "dxr", "dw2", "db1", "db2")
            got = _pairwise_folded(pf.flash_pairwise_bwd_cuda(*args), args)
            want = _pairwise_plain_grads(args)
            _, m["err"], m["errors"] = _grad_errors(names, got, want,
                                                    own_scale=True)
            _, m["control_err"], m["control_errors"] = _grad_errors(
                names, _pairwise_plain_grads(args[:6] + (1.0,)), want,
                own_scale=True)
            if not m["err"] <= GRAD_RTOL:
                raise AssertionError(f"pairwise_bwd on the step's inputs: "
                                     f"{m['errors']}")
            if m["pairs"] and not m["control_err"] > GRAD_RTOL:
                raise AssertionError(f"pairwise_bwd on the step's inputs: "
                                     f"the control passes the limit: "
                                     f"{m['control_errors']}")
            del got, want
            torch.cuda.empty_cache()
    return res


def _pairwise_fwd_on_path(fn) -> dict:
    """The pairwise forward's two calls as one call of ``fn`` (a train
    step) launches them ("no_inter": discoverer 0, shared params;
    "inter": the intervention discoverers, per sample), each held against
    the plain version on its own inputs (PAIRWISE_ATOL, bit for bit on a
    rerun) and timed there."""
    from ctvae_torch.ops import pairwise_flash as pf
    res = {}
    for args, _ in _calls_of(pf, "flash_pairwise_cuda", fn):
        args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
        m = res["no_inter" if args[2].dim() == 1 else "inter"] = \
            _pairwise_fwd_check(args)
        if not m["ok"]:
            raise AssertionError(f"pairwise_fwd on the step's inputs: {m}")
    return res


def _gat_fwd_on_path(fn) -> dict:
    """The GAT forward as one call of ``fn`` (a train step) launches it:
    the share of (source, target) pairs that are edges (the kernel walks
    only those, so its time depends on it), and the kernel's time and
    bound on those very inputs."""
    from ctvae_torch.ops import gat_flash as gf
    (args, kw), = _calls_of(gf, "flash_gat_cuda", fn)
    bnd = _gat_fwd_bound(args, kw.get("keep_alpha", False))
    return {"edge_density": float(args[3].float().mean()),
            "shape": list(args[0].shape),
            "ms": time_ms(lambda: gf.flash_gat_cuda(*args, **kw)),
            "bound_ms": bnd[0], "bound_by": bnd[1]}


# the causal step's call (the final GAT layer on the [A*B] virtual batch:
# head 0 and each sample's action head, F = N = 64), the base and action
# steps' and serving's B = 16 calls (K = 1 and 2 heads per sample), and
# bench_gat.py's shape (13 shared heads of 100)
LOGITS_SHAPES = ((MODEL_PARAMS["action_dim"] * BATCH, 2, 64, True),
                 (BATCH, 1, 64, True), (BATCH, 2, 64, True),
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


def _logits_fwd_bound(args):
    """The forward's bound: per element of [B,S,T,K,F] the abs form's add
    and two fmas (5 operations; the leaky select's form took 7)."""
    xl, xr = args[:2]
    B, S, K, F = xl.shape
    return bound_ms(_logits_bytes(args), 5.0 * B * S * xr.shape[1] * K * F)


def _logits_bwd_bound(args, d_e):
    """The backward's bound on these inputs: per element with a non-zero
    upstream gradient (the kernel skips the rest) the slope test (the add,
    the multiply, the compare), the select, the GL and GR adds and the dadj
    and GW fmas (10 operations; with datt's fma per element, 12)."""
    live = int((d_e != 0).sum())
    return bound_ms(_logits_bytes(args, d_e), 10.0 * live * args[0].shape[3])


def _logits_fwd_check(args, ns) -> dict:
    """One forward call against the plain version on its inputs (each
    logit's error over max(1, max |logit|), held to LOGITS_RTOL), a rerun
    bit for bit, and the kernel's time and bound there."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    got = gl.fused_gat_logits_cuda(*args, ns)
    again = gl.fused_gat_logits_cuda(*args, ns)
    want = gat_logits(*args, ns)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(1.0, float(want.abs().max()))
    bnd = _logits_fwd_bound(args)
    return {"shape": list(got.shape), "max_abs_err": err, "rel_err": rel,
            "bit_identical": torch.equal(got, again),
            "ok": rel <= LOGITS_RTOL and bool(torch.isfinite(got).all())
            and torch.equal(got, again),
            "ms": time_ms(lambda: gl.fused_gat_logits_cuda(*args, ns)),
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def _logits_bwd_check(args, d_e, ns) -> dict:
    """One backward call against the plain version's autograd on its
    inputs (each gradient's error over max(1, its scale), held to
    LOGITS_RTOL), a rerun bit for bit, the share of pairs with a gradient
    and the kernel's time and bound there."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    got = gl.fused_gat_logits_bwd_cuda(*args, d_e, ns)
    again = gl.fused_gat_logits_bwd_cuda(*args, d_e, ns)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(gat_logits(*leaves, ns), leaves, d_e)
    torch.cuda.synchronize()
    err, rel, text = _grad_errors(("dxl", "dxr", "dadj", "dwe", "datt"),
                                  got, want)
    same = all(torch.equal(g, h) for g, h in zip(got, again))
    bnd = _logits_bwd_bound(args, d_e)
    return {"shape": list(d_e.shape),
            "live_share": int((d_e != 0).sum()) / d_e.numel(),
            "max_abs_err": err, "rel_err": rel, "errors": text,
            "bit_identical": same, "ok": rel <= LOGITS_RTOL and same,
            "ms": time_ms(lambda: gl.fused_gat_logits_bwd_cuda(
                *args, d_e, ns)),
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def _logits_on_path(fn) -> dict:
    """The per-head logits forward and backward as one call of ``fn`` (a
    train step) launches them, each held against the plain version on its
    own inputs and timed there (``_logits_fwd_check``,
    ``_logits_bwd_check``)."""
    from ctvae_torch.ops import gat_logits as gl
    calls = {}

    def run():
        calls["fwd"] = _calls_of(gl, "fused_gat_logits_cuda", fn)
    calls["bwd"] = _calls_of(gl, "fused_gat_logits_bwd_cuda", run)
    ((*fargs, ns), _), = calls["fwd"]
    ((*bargs, d_e, _), _), = calls["bwd"]
    fargs = [a.detach() for a in fargs]
    res = {"fwd": _logits_fwd_check(fargs, ns),
           "bwd": _logits_bwd_check(bargs, d_e, ns)}
    for which, m in res.items():
        if not m["ok"]:
            raise AssertionError(f"gat_logits_{which} on the step's inputs: "
                                 f"{m}")
    return res


def _logits_label(B, K, F, per_sample) -> str:
    return f"B={B} K={K} F={F} {'per-sample' if per_sample else 'shared'}"


def _check_gat_logits(gen) -> dict:
    """The forward kernel against the plain version at LOGITS_SHAPES, two
    runs bit for bit; the row reports the causal step's shape, with the
    B = 16 calls' times beside it (``ms_at_16`` by heads)."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    row = {"name": "gat_logits_fwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None, "ms_at_16": {}, "bound_ms_at_16": {},
           "plain_ms_at_16": {}, "occupancy": {}}
    notes = []
    for B, K, F, per_sample in LOGITS_SHAPES:
        args, _ = _logits_inputs(gen, B, K, F, per_sample)
        m = _logits_fwd_check(args, 0.2)
        row["max_abs_err"] = max(row["max_abs_err"], m["max_abs_err"])
        row["ok"] &= m["ok"]
        plain = time_ms(lambda: gat_logits(*args, 0.2), reps=5)
        label = _logits_label(B, K, F, per_sample)
        notes.append(f"{label}: max abs err {m['max_abs_err']:.3g} "
                     f"({m['rel_err']:.2g} of scale), rerun bit-identical "
                     f"{m['bit_identical']}; kernel {m['ms']:.4f} ms, plain "
                     f"{plain:.4f} ms, bound {m['bound_ms']:.4f} ms "
                     f"({m['bound_by']})")
        if B > BATCH:   # the row reports the causal step's call
            row.update(ms=m["ms"], plain_ms=plain, bound_ms=m["bound_ms"],
                       bound_by=m["bound_by"])
        if B == BATCH and F == 64:
            row["ms_at_16"][f"K={K}"] = m["ms"]
            row["bound_ms_at_16"][f"K={K}"] = m["bound_ms"]
            row["plain_ms_at_16"][f"K={K}"] = plain
        if per_sample:
            row["occupancy"][f"B={B} K={K}"] = gl.fwd_occupancy(
                B, args[0].shape[1], args[1].shape[1], K, F)
        torch.cuda.empty_cache()
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat_logits {n}")
    log(f"gat_logits occupancy {json.dumps(row['occupancy'])}")
    return row


def _check_gat_logits_bwd(gen) -> dict:
    """The backward kernel against the plain version's autograd at
    LOGITS_SHAPES; two runs must agree bit for bit (no atomics)."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    row = {"name": "gat_logits_bwd", "max_abs_err": 0.0, "ok": True,
           "library_ms": None, "ms_at_16": {}, "bound_ms_at_16": {},
           "plain_ms_at_16": {}, "occupancy": {}}
    notes = []
    for B, K, F, per_sample in LOGITS_SHAPES:
        args, d_e = _logits_inputs(gen, B, K, F, per_sample)
        m = _logits_bwd_check(args, d_e, 0.2)
        row["max_abs_err"] = max(row["max_abs_err"], m["max_abs_err"])
        row["ok"] &= m["ok"]
        leaves = [a.clone().requires_grad_() for a in args]
        plain_out = gat_logits(*leaves, 0.2)
        plain = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, d_e, retain_graph=True), reps=5)
        del plain_out
        label = _logits_label(B, K, F, per_sample)
        notes.append(f"{label}, {m['live_share']:.4f} of pairs with a "
                     f"gradient: errors {m['errors']}; two runs "
                     f"bit-identical: {m['bit_identical']}; kernel "
                     f"{m['ms']:.4f} ms, plain autograd {plain:.4f} ms, "
                     f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
        if B > BATCH:
            row.update(ms=m["ms"], plain_ms=plain, bound_ms=m["bound_ms"],
                       bound_by=m["bound_by"])
        if B == BATCH and F == 64:
            row["ms_at_16"][f"K={K}"] = m["ms"]
            row["bound_ms_at_16"][f"K={K}"] = m["bound_ms"]
            row["plain_ms_at_16"][f"K={K}"] = plain
        if per_sample:
            row["occupancy"][f"B={B} K={K}"] = gl.bwd_occupancy(
                B, args[0].shape[1], args[1].shape[1], F)
        torch.cuda.empty_cache()
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"gat_logits_bwd {n}")
    log(f"gat_logits_bwd occupancy {json.dumps(row['occupancy'])}")
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


def _profile(label: str, fn) -> list:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the share of its wall time the card was busy. Returns (kernel, ms,
    count) rows, longest first."""
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
        if i < 6 or re.search(r"namespace\)::(vq|pairwise|gat)_\w*kernel[<(]",
                              key):
            log(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")
    return rows


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

def _train_setup():
    """The headline model at B = 16 with the config's exp_params: (model,
    train state, batch, a train step per mode)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    model = build_model(MODEL_PARAMS, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(
        model, build_optimizers(EXP_PARAMS, model, steps_per_epoch=100),
        seed=SEED)
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 3), BATCH,
                        "cuda")
    batch = {"image": x, "input_y": y, "action": a}
    return model, state, batch, {m: make_train_step(m)
                                 for m in EXPECTED_TRAIN}


def phase_train():
    """Train steps of each mode at the headline width, B = 16, with the
    config's exp_params; the launch counters are reset just before and
    read just after. Then one profiled step per mode."""
    model, state, batch, steps = _train_setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
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
    logits = {}
    for mode, step in steps.items():
        m = logits[mode] = _logits_on_path(lambda: step(state, batch))
        f, g = m["fwd"], m["bwd"]
        log(f"train {mode}: per-head logits forward {f['shape']}: max abs "
            f"err {f['max_abs_err']:.3g}, rerun bit-identical "
            f"{f['bit_identical']}; kernel on these inputs {f['ms']:.4f} ms, "
            f"bound {f['bound_ms']:.4f} ms ({f['bound_by']})")
        log(f"train {mode}: per-head logits backward d_e {g['shape']}, "
            f"{g['live_share']:.4f} of pairs with a gradient: errors "
            f"{g['errors']}, rerun bit-identical {g['bit_identical']}; "
            f"kernel on these inputs {g['ms']:.4f} ms, bound "
            f"{g['bound_ms']:.4f} ms ({g['bound_by']})")
    pairwise_bwd = {}
    for mode, step in steps.items():
        calls = pairwise_bwd[mode] = _pairwise_bwd_on_path(
            lambda: step(state, batch), check=True)
        for which, m in calls.items():
            log(f"train {mode}: pairwise backward {which} {m['shape']}, "
                f"live rows {m['live_rows']:.4f}, segments "
                f"{m['live_segments']:.4f}, pairs {m['live_pairs']:.4f}; "
                f"kernel on these inputs {m['ms']:.4f} ms, bound "
                f"{m['bound_ms']:.4f} ms ({m['bound_by']})"
                f"; errors {m['errors']}; control (slope 1) "
                f"{m['control_errors']}")
    pairwise_fwd = _pairwise_fwd_on_path(
        lambda: steps["causal"](state, batch))
    for which, m in pairwise_fwd.items():
        log(f"train causal: pairwise forward {which} {m['shape']}: max abs "
            f"err {m['max_abs_err']:.3g}, rerun bit-identical "
            f"{m['bit_identical']}; kernel on these inputs {m['ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
    profiles = {mode: _profile(f"train step {mode} B={BATCH}",
                               lambda: step(state, batch))
                for mode, step in steps.items()}
    fwd = _gat_fwd_on_path(lambda: steps["causal"](state, batch))
    log(f"train causal: GAT forward xl {fwd['shape']}, edge density "
        f"{fwd['edge_density']:.4f}; kernel on these inputs {fwd['ms']:.4f} "
        f"ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
    # extra keys of the kernels line: what the causal step gives a kernel
    on_step = {"gat_fwd": {"on_causal_step": fwd},
               "gat_logits_fwd": {"on_causal_step": logits["causal"]["fwd"],
                                  "on_steps": {m: v["fwd"] for m, v
                                               in logits.items()}},
               "gat_logits_bwd": {"on_causal_step": logits["causal"]["bwd"],
                                  "on_steps": {m: v["bwd"] for m, v
                                               in logits.items()}},
               "pairwise_bwd": {"on_causal_step": pairwise_bwd["causal"]},
               "pairwise_fwd": {"on_causal_step": pairwise_fwd}}
    for name in ("gat_fwd", "gat_bwd", "pairwise_fwd", "pairwise_bwd",
                 "gat_logits_fwd", "gat_logits_bwd"):
        ms = sum(ms for key, ms, _ in profiles["causal"]
                 if f"{name}_kernel" in key)
        on_step.setdefault(name, {})["profiled_causal_step_ms"] = ms
        log(f"train causal: {name} {ms:.3f} ms of device time in the "
            f"profiled step")
    return timings, launches, peak, on_step


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


# --- a kernel against other builds of it -----------------------------------

def _build_others(stem: str, sources) -> dict:
    """Each of ``sources`` (other versions of ``csrc/<stem>.cu``: an
    earlier commit's, or a variant) built with the tree's flags, one
    ``nvcc`` each, in parallel, and loaded; logs their registers and
    spills. Returns {source: library}."""
    import ctypes
    from ctvae_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs, libs = [], {}
    for k, src in enumerate(sources):
        so = os.path.join(_build.BUILD_DIR, f"lib{stem}-other{k}.so")
        procs.append((src, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, so, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{text}")
        _ptxas(src, text)
        libs[src] = ctypes.CDLL(so)
    return libs


def _in_turns(libs, launch, rounds: int = 3) -> dict:
    """{name: samples}: ``time_ms`` of ``launch(lib)`` for each build,
    ``rounds`` times, the builds in turns (the order reversed every other
    round)."""
    samples = {name: [] for name in libs}
    for rnd in range(rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            samples[name].append(time_ms(lambda: launch(libs[name])))
    return samples


def _host_us_in_turns(libs, launch, rounds: int, calls: int = 100) -> dict:
    """{name: samples}: host microseconds per ``launch(lib)`` call over a
    burst of ``calls`` calls (the card drained before each burst), the
    builds in turns as in ``_in_turns``."""
    samples = {name: [] for name in libs}
    for rnd in range(rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                launch(libs[name])
            samples[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return samples


def _gat_fwd_raw(lib, args, alpha=None) -> torch.Tensor:
    """One raw launch of ``gat_fwd`` from ``lib`` (no wrapper, no launch
    count); writes ``alpha`` when given."""
    from ctvae_torch.ops import _build
    from ctvae_torch.ops.common import warps_for
    xl, xr, adj, mask, we, att, ns = args
    B, S, H, F = xl.shape
    T = xr.shape[1]
    out = torch.empty((B, T, H, F), device="cuda")
    _build.check(lib.gat_fwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), out.data_ptr(),
        None if alpha is None else alpha.data_ptr(), B, S, T, H, F,
        warps_for(T), ns, torch.cuda.current_stream().cuda_stream),
        "gat_fwd")
    return out


def compare_gat_fwd(sources) -> dict:
    """The tree's ``gat_fwd`` against the ``gat_fwd`` of other ``gat.cu``
    files, launched raw on the smoke's inputs at A*B = 192 and B = 16:
    each build's out and alpha against the tree's (max difference, bit for
    bit), its registers, spill bytes and blocks per SM (where it exports
    ``gat_fwd_blocks_per_sm``), and the median over three rounds of
    ``time_ms`` of one serving launch, the builds timed in turns."""
    import ctypes
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.common import warps_for
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {"tree": gf._lib(), **_build_others("gat", sources)}
    for lib in libs.values():
        lib.gat_fwd.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.gat_fwd.restype = ctypes.c_int
    res = {name: {} for name in libs}
    gen = torch.Generator("cuda").manual_seed(SEED)
    for B in (MODEL_PARAMS["action_dim"] * BATCH, BATCH):
        args = _gat_inputs(gen, B)
        xl, xr = args[:2]
        S, (T, H, F) = xl.shape[1], xr.shape[1:]
        outs = {}
        for name, lib in libs.items():
            alpha = torch.empty((B, H, T, S), device="cuda")
            outs[name] = (_gat_fwd_raw(lib, args, alpha), alpha)
        torch.cuda.synchronize()
        want = outs["tree"]
        for name, got in outs.items():
            res[name][f"max_diff_{B}"] = max(
                float((g - w).abs().max()) for g, w in zip(got, want))
            res[name][f"bit_identical_{B}"] = all(
                torch.equal(g, w) for g, w in zip(got, want))
        samples = _in_turns(libs, lambda lib: _gat_fwd_raw(lib, args))
        for name in libs:
            res[name][f"ms_{B}"] = statistics.median(samples[name])
            res[name][f"samples_{B}"] = samples[name]
        del args, outs, want
        torch.cuda.empty_cache()
    for name, lib in libs.items():
        try:
            fn = lib.gat_fwd_blocks_per_sm
        except AttributeError:
            continue
        fn.argtypes, fn.restype = [i] * 4 + [p, p], ctypes.c_int
        res[name].update(gf._occupancy(fn, T, T, F, warps_for(T)))
    for name, r in res.items():
        log(f"gat_fwd {name}: {json.dumps(r)}")
    return res


def _pairwise_bwd_raw(lib, args) -> list:
    """One raw launch of ``pairwise_bwd`` from ``lib`` (no wrapper, no
    launch count): dxl, dxr and the per-sample dw2, db1, db2."""
    from ctvae_torch.ops import _build
    xl, xr, w2, b1, out, dout, ns = args
    B, S, H = xl.shape
    grads = [torch.empty_like(xl), torch.empty_like(xr),
             xl.new_empty((B, H)), xl.new_empty((B, H)), xl.new_empty((B,))]
    _build.check(lib.pairwise_bwd(
        *(t.data_ptr() for t in (xl, xr, w2, b1, out, dout, *grads)),
        B, S, xr.shape[1], H, H if w2.dim() == 2 else 0,
        H if b1.dim() == 2 else 0, ns,
        torch.cuda.current_stream().cuda_stream), "pairwise_bwd")
    return grads


def _paired_times(res, libs, key: str, launch) -> None:
    """Into ``res[name]`` for each build: over PAIRED_ROUNDS rounds of
    ``time_ms`` of ``launch(lib)``, the builds in turns, the median
    (``ms_<key>``), the median ratio to the tree's sample of the same round
    (``vs_tree_<key>``), the rounds it was faster and the samples; on the
    B = 16 dense inputs also the host's microseconds per launch call
    (``host_us_<key>``)."""
    samples = _in_turns(libs, launch, PAIRED_ROUNDS)
    for name in libs:
        pairs = list(zip(samples[name], samples["tree"]))
        res[name][f"ms_{key}"] = statistics.median(samples[name])
        res[name][f"vs_tree_{key}"] = statistics.median(
            a / b for a, b in pairs)
        res[name][f"faster_rounds_{key}"] = sum(a < b for a, b in pairs)
        res[name][f"samples_{key}"] = samples[name]
    if key == f"dense_{BATCH}":
        host = _host_us_in_turns(libs, launch, PAIRED_ROUNDS)
        for name in libs:
            res[name][f"host_us_{key}"] = statistics.median(host[name])


# rounds of --pairwise-bwd-against: enough for a gain of ~1% to win most
# of them against the ~1% spread between calls
PAIRED_ROUNDS = 11


def compare_pairwise_bwd(sources) -> dict:
    """The tree's ``pairwise_bwd`` against the ``pairwise_bwd`` of other
    ``pairwise.cu`` files, launched raw on the check's dense inputs at A*B
    = 192 (per sample) and B = 16 (shared) and on both calls of each train
    mode's own step (captured): each build's gradients against the tree's
    (max difference, bit for bit) and against the plain version's autograd
    (worst error over each gradient's own scale), its registers, spill
    bytes and blocks per SM (where it exports
    ``pairwise_bwd_blocks_per_sm``), and over PAIRED_ROUNDS rounds of
    ``time_ms`` of one launch, the builds timed in turns: the median, and
    against the tree's sample of the same round the median ratio and the
    number of rounds it was faster; and at B = 16 the host's microseconds
    per launch call (median over the rounds, ``host_us_dense_16``)."""
    import ctypes
    from ctvae_torch.ops import pairwise_flash as pf
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {"tree": pf._lib(), **_build_others("pairwise", sources)}
    for lib in libs.values():
        lib.pairwise_bwd.argtypes = [p] * 11 + [i] * 4 + [i64, i64,
                                                          ctypes.c_float, p]
        lib.pairwise_bwd.restype = ctypes.c_int
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = {f"dense_{B}": _pairwise_bwd_inputs(gen, B, B > BATCH)[0]
              for B in (MODEL_PARAMS["action_dim"] * BATCH, BATCH)}
    _, state, batch, steps = _train_setup()
    for mode, step in steps.items():
        for args, _ in _calls_of(pf, "flash_pairwise_bwd_cuda",
                                 lambda: step(state, batch)):
            which = "no_inter" if args[2].dim() == 1 else "inter"
            inputs[f"{mode}_{which}"] = args
    del state, steps
    res = {name: {} for name in libs}
    shares = {}
    for key, args in inputs.items():
        live = shares[key] = _pairwise_live(args)
        want = _pairwise_plain_grads(args)
        outs = {name: _pairwise_bwd_raw(lib, args)
                for name, lib in libs.items()}
        torch.cuda.synchronize()
        for name, got in outs.items():
            r = res[name]
            r[f"max_diff_{key}"] = max(float((g - w).abs().max()) for g, w
                                       in zip(got, outs["tree"]))
            r[f"bit_identical_{key}"] = all(
                torch.equal(g, w) for g, w in zip(got, outs["tree"]))
            r[f"err_{key}"] = _grad_errors(
                ("dxl", "dxr", "dw2", "db1", "db2"),
                _pairwise_folded(got, args), want, own_scale=True)[1]
        del want, outs
        torch.cuda.empty_cache()
        _paired_times(res, libs, key,
                      lambda lib: _pairwise_bwd_raw(lib, args))
        log(f"pairwise_bwd inputs {key}: {json.dumps(live)}; bound "
            f"{_pairwise_bwd_bound(args, live['pairs'])[0]:.4f} ms")
    for name, lib in libs.items():
        try:
            res[name].update(pf.bwd_occupancy(64, 64, lib))
        except AttributeError:
            pass
    for name, r in res.items():
        log(f"pairwise_bwd {name}: {json.dumps(r)}")
    return {"inputs": shares, "builds": res}


def _pairwise_fwd_raw(lib, args) -> torch.Tensor:
    """One raw launch of ``pairwise_fwd`` from ``lib`` (no wrapper, no
    launch count)."""
    from ctvae_torch.ops import _build
    xl, xr, w2, b1, b2, ns = args
    B, S, H = xl.shape
    T = xr.shape[1]
    out = torch.empty((B, S, T), device="cuda")
    _build.check(lib.pairwise_fwd(
        *(t.data_ptr() for t in (xl, xr, w2, b1, b2, out)), B, S, T, H,
        H if w2.dim() == 2 else 0, H if b1.dim() == 2 else 0,
        1 if b2.dim() == 1 else 0, ns,
        torch.cuda.current_stream().cuda_stream), "pairwise_fwd")
    return out


def compare_pairwise_fwd(sources) -> dict:
    """The tree's ``pairwise_fwd`` against the ``pairwise_fwd`` of other
    ``pairwise.cu`` files, launched raw on the check's inputs at A*B = 192
    (per sample) and B = 16 (shared) and on both calls of each train
    mode's own step (captured): each build's output against the tree's
    (max difference, bit for bit), against the plain version (max abs
    error) and against its own rerun (bit for bit), its registers, spill
    bytes and blocks per SM (where it exports
    ``pairwise_fwd_blocks_per_sm``), and over PAIRED_ROUNDS rounds of
    ``time_ms`` of one launch, the builds timed in turns: the median, and
    against the tree's sample of the same round the median ratio and the
    number of rounds it was faster; and at B = 16 the host's microseconds
    per launch call (median over the rounds, ``host_us_dense_16``)."""
    import ctypes
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {"tree": pf._lib(), **_build_others("pairwise", sources)}
    for lib in libs.values():
        lib.pairwise_fwd.argtypes = [p] * 6 + [i] * 4 + [i64] * 3 + [
            ctypes.c_float, p]
        lib.pairwise_fwd.restype = ctypes.c_int
    gen = torch.Generator("cuda").manual_seed(SEED)
    A = MODEL_PARAMS["action_dim"]
    inputs = {f"dense_{B}": _pairwise_fwd_inputs(gen, B, B > BATCH)
              for B in (A * BATCH, BATCH)}
    _, state, batch, steps = _train_setup()
    for mode, step in steps.items():
        for args, _ in _calls_of(pf, "flash_pairwise_cuda",
                                 lambda: step(state, batch)):
            which = "no_inter" if args[2].dim() == 1 else "inter"
            inputs[f"{mode}_{which}"] = tuple(
                a.detach() if torch.is_tensor(a) else a for a in args)
    del state, steps
    res = {name: {} for name in libs}
    for key, args in inputs.items():
        with torch.no_grad():
            want = fused_pairwise_scores(*args)
        outs = {name: (_pairwise_fwd_raw(lib, args),
                       _pairwise_fwd_raw(lib, args))
                for name, lib in libs.items()}
        torch.cuda.synchronize()
        for name, (got, again) in outs.items():
            r = res[name]
            r[f"max_diff_{key}"] = float((got - outs["tree"][0]).abs().max())
            r[f"bit_identical_{key}"] = torch.equal(got, outs["tree"][0])
            r[f"rerun_identical_{key}"] = torch.equal(got, again)
            r[f"err_{key}"] = float((got - want).abs().max())
        del want, outs
        torch.cuda.empty_cache()
        _paired_times(res, libs, key,
                      lambda lib: _pairwise_fwd_raw(lib, args))
        log(f"pairwise_fwd inputs {key}: shape {list(args[0].shape)} x "
            f"{args[1].shape[1]}, per-sample {args[2].dim() == 2}; bound "
            f"{_pairwise_fwd_bound(args)[0]:.4f} ms")
    for name, lib in libs.items():
        try:
            res[name].update(pf.fwd_occupancy(A * BATCH, 64, 64, 800, lib))
        except AttributeError:
            pass
    for name, r in res.items():
        log(f"pairwise_fwd {name}: {json.dumps(r)}")
    return res


def _logits_lib(lib):
    """Set the argument types of a ``gat_logits.cu`` build's entry points
    (the backward's differ between the split design, which exports
    ``gat_logits_bwd_parts``, and the earlier one block per (b, k))."""
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gat_logits_fwd.argtypes = [p] * 6 + [i] * 6 + [f, p]
    lib.gat_logits_fwd.restype = ctypes.c_int
    try:
        lib.gat_logits_bwd_parts.argtypes = [i, i, i]
        lib.gat_logits_bwd.argtypes = [p] * 10 + [i] * 6 + [f, p]
    except AttributeError:
        lib.gat_logits_bwd.argtypes = [p] * 11 + [i] * 7 + [f, p]
    lib.gat_logits_bwd.restype = ctypes.c_int
    return lib


def _logits_fwd_raw(lib, args, ns) -> torch.Tensor:
    """One raw launch of ``gat_logits_fwd`` from ``lib`` (no wrapper, no
    launch count)."""
    from ctvae_torch.ops import _build
    xl, xr, adj, we, att = args
    B, S, K, F = xl.shape
    T = xr.shape[1]
    out = xl.new_empty((B, S, T, K))
    _build.check(lib.gat_logits_fwd(
        *(t.data_ptr() for t in (xl, xr, adj, we, att, out)), B, S, T, K, F,
        K * F if we.dim() == 3 else 0, ns,
        torch.cuda.current_stream().cuda_stream), "gat_logits_fwd")
    return out


def _logits_bwd_raw(lib, args, d_e, ns, fold: bool = True):
    """One raw launch of ``gat_logits_bwd`` from ``lib`` (no wrapper, no
    launch count); with ``fold`` also the sums its wrapper takes, returning
    dxl, dxr, dadj [B,S,T], dwe, datt (we's shape)."""
    from ctvae_torch.ops import _build
    from ctvae_torch.ops.common import warps_for
    xl, xr, adj, we, att = args
    B, S, K, F = xl.shape
    T = xr.shape[1]
    wstride = K * F if we.dim() == 3 else 0
    stream = torch.cuda.current_stream().cuda_stream
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    ptrs = [t.data_ptr() for t in (xl, xr, adj, we, att, d_e, dxl, dxr)]
    if hasattr(lib, "gat_logits_bwd_parts"):
        dadj = xl.new_empty((B, S, T))
        part = xl.new_empty((B, lib.gat_logits_bwd_parts(B, S, T), 2, K, F))
        _build.check(lib.gat_logits_bwd(
            *ptrs, dadj.data_ptr(), part.data_ptr(), B, S, T, K, F, wstride,
            ns, stream), "gat_logits_bwd")
        if not fold:
            return None
        dwe, datt = part.sum(1 if wstride else (0, 1)).unbind(-3)
        return dxl, dxr, dadj, dwe, datt
    dadj_k = xl.new_empty((B, K, S, T))
    dwe, datt = xl.new_empty((B, K, F)), xl.new_empty((B, K, F))
    _build.check(lib.gat_logits_bwd(
        *ptrs, dadj_k.data_ptr(), dwe.data_ptr(), datt.data_ptr(), B, S, T,
        K, F, wstride, warps_for(max(S, T)), ns, stream), "gat_logits_bwd")
    if not fold:
        return None
    if wstride == 0:
        dwe, datt = dwe.sum(0), datt.sum(0)
    return dxl, dxr, dadj_k.sum(1), dwe, datt


def _logits_compare_inputs(gen) -> dict:
    """{key: (args, d_e, ns)}: the per-head logits calls of each train
    mode's own step (captured, forward args with the backward's d_e), the
    check's inputs at A*B = 192 (K = 2) and at B = 16 with K = 1 and K = 2
    (F = 64, per-sample heads as ``heads_call`` gives them), and the A*B =
    192 inputs with an all-zero d_e."""
    from ctvae_torch.ops import gat_logits as gl
    A = MODEL_PARAMS["action_dim"]
    inputs = {}
    for B, K in ((A * BATCH, 2), (BATCH, 1), (BATCH, 2)):
        args, d_e = _logits_inputs(gen, B, K, 64, True)
        inputs[f"check_{B}_k{K}"] = (args, d_e, 0.2)
    args, d_e, ns = inputs[f"check_{A * BATCH}_k2"]
    inputs["zero_de"] = (args, torch.zeros_like(d_e), ns)
    _, state, batch, steps = _train_setup()
    for mode, step in steps.items():
        (*args, d_e, ns), _ = _calls_of(gl, "fused_gat_logits_bwd_cuda",
                                        lambda: step(state, batch))[0]
        inputs[f"{mode}_step"] = (tuple(a.detach() for a in args), d_e, ns)
    del state, steps
    return inputs


def compare_gat_logits(sources) -> dict:
    """The tree's ``gat_logits_fwd`` / ``gat_logits_bwd`` against those of
    other ``gat_logits.cu`` files, launched raw on ``_logits_compare_inputs``:
    each build's logits and gradients against the tree's (max difference,
    bit for bit), against the plain version and its autograd (the worst
    error over max(1, scale), as the smoke's LOGITS_RTOL takes it) and
    against its own rerun (bit for bit); its registers, spill bytes and
    blocks per SM (where it exports them); and over PAIRED_ROUNDS rounds of
    ``time_ms``, the builds in turns: the median, the median ratio to the
    tree's sample of the same round and the rounds it was faster, of the
    forward (``fwd``), of the backward with the sums its wrapper takes
    (``bwd``) and of the backward kernel alone (``bwd_kernel``)."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    libs = {"tree": gl._lib(), **_build_others("gat_logits", sources)}
    for lib in libs.values():
        _logits_lib(lib)
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = _logits_compare_inputs(gen)
    res = {name: {} for name in libs}
    shapes = {}
    names = ("dxl", "dxr", "dadj", "dwe", "datt")
    for key, (args, d_e, ns) in inputs.items():
        xl = args[0]
        live = int((d_e != 0).sum())
        shapes[key] = {"shape": list(d_e.shape), "live_share":
                       live / d_e.numel()}
        want = gat_logits(*args, ns)
        leaves = [a.clone().requires_grad_() for a in args]
        want_g = torch.autograd.grad(gat_logits(*leaves, ns), leaves, d_e)
        del leaves
        outs = {name: (_logits_fwd_raw(lib, args, ns),
                       _logits_fwd_raw(lib, args, ns),
                       _logits_bwd_raw(lib, args, d_e, ns),
                       _logits_bwd_raw(lib, args, d_e, ns))
                for name, lib in libs.items()}
        torch.cuda.synchronize()
        tree = outs["tree"]
        for name, (e, e2, g, g2) in outs.items():
            r = res[name]
            r[f"fwd_err_{key}"] = float((e - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            r[f"fwd_diff_{key}"] = float((e - tree[0]).abs().max())
            r[f"fwd_rerun_identical_{key}"] = torch.equal(e, e2)
            r[f"bwd_err_{key}"] = _grad_errors(names, g, want_g)[1]
            r[f"bwd_diff_{key}"] = max(float((a - b).abs().max())
                                       for a, b in zip(g, tree[2]))
            r[f"bwd_rerun_identical_{key}"] = all(
                torch.equal(a, b) for a, b in zip(g, g2))
        del outs, tree, want, want_g
        torch.cuda.empty_cache()
        if key != "zero_de":
            _paired_times(res, libs, f"fwd_{key}",
                          lambda lib: _logits_fwd_raw(lib, args, ns))
        _paired_times(res, libs, f"bwd_{key}",
                      lambda lib: _logits_bwd_raw(lib, args, d_e, ns))
        _paired_times(res, libs, f"bwd_kernel_{key}",
                      lambda lib: _logits_bwd_raw(lib, args, d_e, ns,
                                                  fold=False))
        B, S, K, F = xl.shape
        T = args[1].shape[1]
        shapes[key]["bound_ms_fwd"] = _logits_fwd_bound(args)[0]
        shapes[key]["bound_ms_bwd"] = _logits_bwd_bound(args, d_e)[0]
        log(f"gat_logits inputs {key}: {json.dumps(shapes[key])}")
        for name, lib in libs.items():
            for which, occ in (
                    ("fwd", lambda: gl.fwd_occupancy(B, S, T, K, F, lib)),
                    ("bwd", lambda: gl.bwd_occupancy(B, S, T, F, lib))):
                try:
                    res[name][f"{which}_occupancy_{key}"] = occ()
                except AttributeError:
                    continue
    for name, r in res.items():
        log(f"gat_logits {name}: {json.dumps(r)}")
    return {"inputs": shapes, "builds": res}


# keys of a check's row that the kernels line carries beside the contract's
EXTRA_KEYS = ("ms_at_16", "bound_ms_at_16", "plain_ms_at_16", "alpha_ms",
              "occupancy")

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


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--gat-fwd-against", nargs="+", metavar="GAT_CU",
        help="only build the kernels and compare the tree's gat_fwd with "
             "the gat_fwd of these gat.cu files (compare_gat_fwd)")
    parser.add_argument(
        "--pairwise-bwd-against", nargs="+", metavar="PAIRWISE_CU",
        help="only build the kernels and compare the tree's pairwise_bwd "
             "with the pairwise_bwd of these pairwise.cu files "
             "(compare_pairwise_bwd)")
    parser.add_argument(
        "--pairwise-fwd-against", nargs="+", metavar="PAIRWISE_CU",
        help="only build the kernels and compare the tree's pairwise_fwd "
             "with the pairwise_fwd of these pairwise.cu files "
             "(compare_pairwise_fwd)")
    parser.add_argument(
        "--gat-logits-against", nargs="+", metavar="GAT_LOGITS_CU",
        help="only build the kernels and compare the tree's gat_logits_fwd "
             "and gat_logits_bwd with those of these gat_logits.cu files "
             "(compare_gat_logits)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on a card",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    phase_card()
    phase_build()
    if opts.gat_fwd_against:
        log(json.dumps({"gat_fwd_against": compare_gat_fwd(
            opts.gat_fwd_against)}))
        return 0
    if opts.pairwise_fwd_against:
        log(json.dumps({"pairwise_fwd_against": compare_pairwise_fwd(
            opts.pairwise_fwd_against)}))
        return 0
    if opts.gat_logits_against:
        log(json.dumps({"gat_logits_against": compare_gat_logits(
            opts.gat_logits_against)}))
        return 0
    if opts.pairwise_bwd_against:
        log(json.dumps({"pairwise_bwd_against": compare_pairwise_bwd(
            opts.pairwise_bwd_against)}))
        return 0
    rows = phase_kernels()
    model, timings, serve_launches = phase_serve()
    phase_reference(model)
    phase_profile(model)
    del model
    train_ms, train_launches, peak, on_step = phase_train()
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
        # the check's other sizes and occupancy, and what the causal step
        # gives the kernel
        kernels[-1].update({k: r[k] for k in EXTRA_KEYS if k in r})
        kernels[-1].update(on_step.get(r["name"], {}))
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
    sys.exit(main(sys.argv[1:]))
