#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ctvae_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the seven CUDA kernels of ``ctvae_torch/csrc`` (four sources, one
``nvcc`` each, in parallel) and holds each against its plain PyTorch
version at the shapes of ``configs/ct_mcq_vae.yaml``: the four forward
kernels at the serving shapes, the three backward kernels (pairwise scores,
GATv2 attention, GATv2 per-head logits) against the plain versions'
autograd. Then it drives the port's four paths at that width, each with
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
* training past 120 latent sites: the headline widths with ``codebooks:
  2`` (S = 128 sites, 129 GAT nodes, as the CT search configs search
  it), a warm and a timed train step per mode, every kernel launched in
  every mode, and each mode's pairwise and GAT backward calls held
  against the plain autograd and timed on their own inputs;
* the two-stage recipe on TSynthetic (64x64, the headline widths with its
  8 actions): an MCQVAE pretrained for one epoch and saved, its weights
  restored alone into a CTMCQVAE, one ``VAEXperiment.fit`` epoch of
  ``ct_layer`` with checkpoints, a full-state resume into a fresh
  experiment, and ``apply_action`` (rollout, walk, navigate, causal
  sweep), with the bitwise checks of each stage.

Before that, ``VAEXperiment.fit`` runs one short epoch on TSynthetic at the
same widths (phase "loop"). Then four more phases:

* scan: per train mode, 16 steps at the headline widths and B = 16
  taken eagerly from one state and through ``make_multi_train_step(mode,
  8)`` (warm-up steps, then replays of a captured CUDA graph) from an
  equal state on the same batches: every parameter and Adam moment
  within 1e-6 of its largest magnitude, the generators and steps equal;
  then both timed in turns. The graph's kernel launches are counted at
  capture, times its replays (the ``scan`` path of the kernels line);
* bench: ``python -m ctvae_torch.bench --blocks 2`` at its default
  config, its last line checked for every key and an ``mfu`` in (0, 1]
  per mode, and printed.
* shapes3d: ``configs/mcq_vae.yaml`` and ``configs/ct_mcq_vae.yaml`` as
  ``config.read_config`` reads them, trained one epoch each through
  ``run.train`` on a Shapes3D stand-in (30,720 images, all six factors)
  that the port writes to a temporary directory, with their checkpoints,
  ``scalars.jsonl`` and image grids checked, then ``apply_action`` on the
  CT checkpoint; the launch counters are read per config (paths
  ``shapes3d_mcq`` and ``shapes3d_ct``). Then the loader's host ms per
  batch, the pinned copy's ms, train steps on real batches, every VQ
  search call of each mode's step of both configs and every other kernel
  call of a base, an action and a causal TShapes3D step held against its
  plain version, and each epoch's first steps again in turns with its
  batches held, assembled on a loader thread and inline: the loader's
  share of the epoch.
* metrics: ``configs/ct_mcq_vae.yaml`` trained one epoch through
  ``run.train`` on the same stand-in with ``exp_params.metrics`` = DCI,
  MIG, SAP, FactorVaeScore (the launch counters read as path
  ``metrics``), each metric's card seconds at both headline configs'
  sample sizes, one DCI fit profiled, and the four metric functions on
  the card against the CPU over one table of 256 codes.

The second-last line is one JSON
object with a row per kernel; the last line is ``{"ok": true, "device":
{...}}``. Any failed phase exits non-zero and prints no result; so does a
machine without a card. TF32 is off for matmuls and cuDNN convolutions, so
every number here is full float32.

    python3 chip_smoke.py --gat-fwd-against OTHER/gat.cu [...]

builds the kernels and only compares the tree's GAT forward with the
forward of other ``gat.cu`` files (an earlier commit's, or a variant):
outputs bit for bit, registers and occupancy, and times taken in turns
(``compare_gat_fwd``).

    python3 chip_smoke.py --gat-bwd-against OTHER/gat.cu [...]

does the same for its backward, with its wrapper's sums, on the check's
inputs and on the calls of each train mode's step (codebooks 1 and 2),
with each build's error against the plain autograd (``compare_gat_bwd``).

    python3 chip_smoke.py --pairwise-bwd-against OTHER/pairwise.cu [...]

does the same for the pairwise scores' backward, on dense inputs and on
the inputs each train mode's step gives it, with each build's error
against the plain autograd (``compare_pairwise_bwd``).

    python3 chip_smoke.py --pairwise-fwd-against OTHER/pairwise.cu [...]

and for the pairwise scores' forward, with each build's error against
the plain version (``compare_pairwise_fwd``).

    python3 chip_smoke.py --vq-against OTHER/vq.cu [...]

and for the VQ search, on the check's inputs at D = 128, 64 and 32 and on
the calls of each train mode's step (codebooks 1 and 2), with each
build's index agreement with the plain version (``compare_vq``).

    python3 chip_smoke.py --gat-logits-against OTHER/gat_logits.cu [...]

and for the GATv2 per-head logits, forward and backward, on the calls of
each train mode's step and on the check's inputs at A*B = 192 and B = 16
(``compare_gat_logits``).

    python3 chip_smoke.py --metrics-only

builds the kernels and runs only the phase "metrics" (``phase_metrics``).

    python3 chip_smoke.py --train-step-against OTHER_CHECKOUT [...]

times the tree's eager train step of each mode in turns with that of
other checkouts' ``ctvae_torch`` (an earlier commit's), at the headline
widths and B = 16 (``compare_train_step``).
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

from ctvae_torch.config import read_config, read_section

# the headline configuration, read without PyYAML (the card's machine has
# none)
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "ct_mcq_vae.yaml")
MODEL_PARAMS = read_section(CONFIG, "model_params")
EXP_PARAMS = read_section(CONFIG, "exp_params")
# the loop phase: the headline widths on TSynthetic, whose grid has 4
# factors and so 8 actions (phase "shapes3d" trains the config as it is)
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

def _vq_agreement(x, cb, got) -> tuple:
    """The kernel's indices against the plain version's: (indices that
    differ, of them near-ties, the largest distance gap in float64)."""
    from ctvae_torch.ops import vq
    want = vq.l2_argmin_plain(x, cb)
    dist = (x.double() ** 2).sum(1, keepdim=True) \
        + (cb.double() ** 2).sum(1) - 2 * x.double() @ cb.double().T
    d_got = dist.gather(1, got[:, None])[:, 0]
    d_want = dist.gather(1, want[:, None])[:, 0]
    gap = (d_got - d_want).abs()
    differ = got != want
    near_tie = gap <= VQ_TIE_RTOL * d_want.abs().clamp(min=1.0)
    return int(differ.sum()), int((differ & near_tie).sum()), float(gap.max())


def _vq_bound(x, cb):
    """Bytes: x and the codebook read once, the int64 indices written once.
    Operations: the 2 N K D of the products (the norms add K D)."""
    (N, D), K = x.shape, cb.shape[0]
    return bound_ms(4 * (N * D + K * D) + 8 * N, 2.0 * N * K * D)


def _vq_on_path(fn) -> list:
    """The VQ search's calls as one call of ``fn`` (a train step) makes
    them, each held against the plain version on its own inputs: indices
    equal except on counted near-ties (``_vq_agreement``), a rerun bit for
    bit; and the kernel's, the plain version's and ``cdist`` + ``argmin``'s
    times and the bound on those inputs."""
    from ctvae_torch.ops import vq
    out = []
    for args, _ in _calls_of(vq, "l2_argmin_cuda", fn):
        x, cb = (a.detach() for a in args[:2])
        got = vq.l2_argmin_cuda(x, cb)
        same = torch.equal(vq.l2_argmin_cuda(x, cb), got)
        differ, ties, gap = _vq_agreement(x, cb, got)
        out.append({"x": list(x.shape), "differ": differ, "near_ties": ties,
                    "max_distance_gap": gap, "bit_identical": same,
                    "ms": time_ms(lambda: vq.l2_argmin_cuda(x, cb)),
                    "plain_ms": time_ms(lambda: vq.l2_argmin_plain(x, cb)),
                    "library_ms": time_ms(
                        lambda: torch.cdist(x, cb).argmin(1))})
        out[-1]["bound_ms"], out[-1]["bound_by"] = _vq_bound(x, cb)
        if differ != ties or not same:
            raise AssertionError(f"vq on the step's inputs: {out[-1]}")
    return out


# D of the VQ search: the headline's embedding of 128 over 1, 2 and 4
# codebooks (configs/ct_mcq_vae.yaml, the codebooks: 2 of the CT search
# configs, configs/mcq_vae.yaml)
VQ_DIMS = (128, 64, 32)


def _check_vq(gen) -> dict:
    """The VQ search against the plain version at N = 1024 rows, K = 64
    codes and each D of VQ_DIMS: indices equal except on counted near-ties,
    a rerun bit for bit; the kernel's, the plain version's and ``cdist`` +
    ``argmin``'s times, the bound and the occupancy. The row reports D =
    128; ``by_d`` each D."""
    from ctvae_torch.ops import vq
    N, K = BATCH * 64, MODEL_PARAMS["num_embeddings"]
    row = {"name": "vq_l2_argmin", "max_abs_err": 0.0, "ok": True,
           "by_d": {}}
    notes = []
    for D in VQ_DIMS:
        x = torch.randn(N, D, generator=gen, device="cuda") * 0.3
        cb = (torch.rand(K, D, generator=gen, device="cuda") * 2 - 1) / K
        got = vq.l2_argmin_cuda(x, cb)
        same = torch.equal(vq.l2_argmin_cuda(x, cb), got)
        differ, ties, gap = _vq_agreement(x, cb, got)
        m = row["by_d"][str(D)] = {
            "differ": differ, "near_ties": ties, "max_abs_err": gap,
            "bit_identical": same,
            "ms": time_ms(lambda: vq.l2_argmin_cuda(x, cb)),
            "plain_ms": time_ms(lambda: vq.l2_argmin_plain(x, cb)),
            "library_ms": time_ms(lambda: torch.cdist(x, cb).argmin(1)),
            "occupancy": vq.occupancy(K, D)}
        m["bound_ms"], m["bound_by"] = _vq_bound(x, cb)
        row["ok"] &= differ == ties and same
        row["max_abs_err"] = max(row["max_abs_err"], gap)
        notes.append(f"N={N} K={K} D={D}: {differ} of {N} indices differ, "
                     f"{ties} of them near-ties (distance gap <= "
                     f"{VQ_TIE_RTOL} rel), max distance gap {gap:.3g}; rerun "
                     f"bit-identical {same}; kernel {m['ms']:.4f} ms, plain "
                     f"{m['plain_ms']:.4f} ms, cdist+argmin "
                     f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
                     f"({m['bound_by']}); occupancy "
                     f"{json.dumps(m['occupancy'])}")
    head = row["by_d"][str(VQ_DIMS[0])]
    row.update({k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "occupancy")})
    row["note"] = "; ".join(notes)
    for n in notes:
        log(f"vq {n}")
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


def _pairwise_fwd_plain(args, chunk: int = BATCH) -> torch.Tensor:
    """The plain version on the forward's arguments, ``chunk`` samples at
    a time (its [B, S, T, Hd] domain at the causal step's A*B = 192 and S =
    T = 128 takes 10 GB a tensor); per-sample params (w2, b1 [B, Hd], b2
    [B]) are sliced with the samples."""
    from ctvae_torch.ops.pairwise import fused_pairwise_scores
    xl, xr, w2, b1, b2, ns = args
    parts = []
    for c in range(0, xl.shape[0], chunk):
        sl = slice(c, c + chunk)
        parts.append(fused_pairwise_scores(
            xl[sl], xr[sl], w2[sl] if w2.dim() == 2 else w2,
            b1[sl] if b1.dim() == 2 else b1, b2[sl] if b2.dim() == 1 else b2,
            ns))
    return torch.cat(parts)


def _pairwise_fwd_check(args) -> dict:
    """One forward call of the wrapper against the plain version on
    ``args``: the max abs error, whether a second call agrees bit for
    bit, the kernel's time and the bound."""
    from ctvae_torch.ops import pairwise_flash as pf

    def fn(a):
        return pf.flash_pairwise_cuda(*a)
    with torch.no_grad():
        got, again = fn(args), fn(args)
        want = _pairwise_fwd_plain(args)
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


def _pairwise_plain_grads(args, chunk: int = BATCH) -> list:
    """The plain version's autograd from the kernel's own residual ``out``:
    the gradients of the logits z = sum_h leaky(pre) w2 against dz = dout
    out (1 - out), what the sigmoid's backward hands them; dw2, db1 and
    db2 folded into their param's shape. Taken ``chunk`` samples at a time
    (pre of the causal step at S = T = 128 takes 10 GB whole): per-sample
    gradients concatenate, a shared param's sum over the chunks."""
    from ctvae_torch.ops.pairwise import _bh
    xl, xr, w2, b1, out, dout, ns = args
    out, dout = out.detach(), dout.detach()
    parts = []
    for c in range(0, xl.shape[0], chunk):
        sl = slice(c, c + chunk)
        leaves = [t.detach()[sl].clone().requires_grad_() if t.dim() == k
                  else t.detach().clone().requires_grad_()
                  for t, k in ((xl, 3), (xr, 3), (w2, 2), (b1, 2))]
        pre = leaves[0][:, :, None, :] + leaves[1][:, None, :, :] \
            + _bh(leaves[3])
        z = torch.sum(torch.where(pre >= 0, pre, ns * pre)
                      * _bh(leaves[2]), -1)
        dz = dout[sl] * out[sl] * (1 - out[sl])
        grads = list(torch.autograd.grad(z, leaves, dz))
        del pre, z
        parts.append(grads + [dz.sum((1, 2)) if w2.dim() == 2
                              else dz.sum()])
    per_sample = (True, True, w2.dim() == 2, b1.dim() == 2, w2.dim() == 2)
    return [torch.cat([p[i] for p in parts]) if per_sample[i]
            else sum(p[i] for p in parts) for i in range(5)]


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


def _gat_bwd_bound(xl, xr, mask):
    """Bytes: xl, xr, dout, dxl and dxr, alpha and dadj per head, adj,
    mask and its gradient, we / att and theirs. Operations per edge, head
    and feature: pre (3), slope select and multiply, the dxr add, the
    dadj, dwe, datt and dalpha fmas (2 each), the dxl add and fma."""
    B, S, H, F = xl.shape
    T = xr.shape[1]
    nbytes = 4 * (3 * B * (S + T) * H * F + 2 * B * S * T + B * H * S * T
                  + 4 * H * F) + B * S * T
    return bound_ms(nbytes, 17.0 * int(mask.sum()) * H * F)


def _gat_plain_grads(args, chunk: int = BATCH) -> list:
    """The plain version's gradients from the kernel's own residual alpha
    [B, H, T, S], as ``_pairwise_plain_grads`` takes them from ``out``: the
    softmax's VJP de = alpha (dalpha - sum_s alpha dalpha) with dalpha =
    dout . xl, the logits' autograd against de, and sum_t alpha dout added
    to dxl; ``chunk`` samples at a time (dwe, datt summed over them). A
    softmax recomputed from the logits would differ from the residual by
    its rounding, which the cancellation in de amplifies to ~1% of a train
    step's small GAT gradients (the parent kernel's too)."""
    from ctvae_torch.ops.gat import gat_logits
    xl, xr, adj, mask, we, att, alpha, dout, ns = args
    parts = []
    for c in range(0, xl.shape[0], chunk):
        sl = slice(c, c + chunk)
        leaves = [t[sl].detach().clone().requires_grad_()
                  for t in (xl, xr, adj)]
        leaves += [we.detach().clone().requires_grad_(),
                   att.detach().clone().requires_grad_()]
        a = alpha[sl].permute(0, 3, 2, 1)            # [b, S, T, H]
        d = dout[sl]
        dalpha = torch.einsum("bthf,bshf->bsth", d, xl[sl])
        de = a * (dalpha - (a * dalpha).sum(1, keepdim=True))
        g = list(torch.autograd.grad(gat_logits(*leaves, ns), leaves, de))
        g[0] = g[0] + torch.einsum("bsth,bthf->bshf", a, d)
        parts.append(g)
    return [torch.cat([p[i] for p in parts]) for i in range(3)] + \
        [sum(p[i] for p in parts) for i in (3, 4)]


def _gat_bwd_on_path(fn) -> dict:
    """The GAT backward as one call of ``fn`` (a train step) launches it:
    the edge density, the kernel's time and bound on those very inputs,
    and its gradients against the plain version's (``_gat_plain_grads``),
    each gradient's error over its own scale held to GRAD_RTOL, and a
    rerun bit for bit."""
    from ctvae_torch.ops import gat_flash as gf
    (args, _), = _calls_of(gf, "flash_gat_bwd_cuda", fn)
    xl, xr, adj, mask, we, att, alpha, dout, ns = args
    got = gf.flash_gat_bwd_cuda(*args)
    same = all(torch.equal(g, h)
               for g, h in zip(got, gf.flash_gat_bwd_cuda(*args)))
    want = _gat_plain_grads(args)
    _, err, text = _grad_errors(("dxl", "dxr", "dadj", "dwe", "datt"), got,
                                want, own_scale=True)
    del got, want
    torch.cuda.empty_cache()
    if not (err <= GRAD_RTOL and same):
        raise AssertionError(f"gat_bwd on the step's inputs: {text}; rerun "
                             f"bit-identical {same}")
    bnd = _gat_bwd_bound(xl, xr, mask)
    return {"shape": list(xl.shape), "edge_density":
            float(mask.float().mean()), "err": err, "errors": text,
            "bit_identical": same,
            "ms": time_ms(lambda: gf.flash_gat_bwd_cuda(*args)),
            "bound_ms": bnd[0], "bound_by": bnd[1]}


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
        bnd = _gat_bwd_bound(xl, xr, mask)
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


def _gat_fwd_plain(args, chunk: int = BATCH):
    """The plain version's out [B, T, H, F] and alpha [B, H, T, S] (the
    masked softmax of the logits) on the forward's arguments, ``chunk``
    samples at a time."""
    from ctvae_torch.ops.gat import gat_logits, masked_incoming_softmax
    from ctvae_torch.ops.gat_flash import flash_gat_plain
    xl, xr, adj, mask, we, att, ns = args
    outs, alphas = [], []
    for c in range(0, xl.shape[0], chunk):
        part = (xl[c:c + chunk], xr[c:c + chunk], adj[c:c + chunk],
                mask[c:c + chunk], we, att, ns)
        outs.append(flash_gat_plain(*part))
        alphas.append(masked_incoming_softmax(
            gat_logits(*part[:3], we, att, ns), part[3]).permute(0, 3, 2, 1))
    return torch.cat(outs), torch.cat(alphas)


def _gat_fwd_on_path(fn) -> dict:
    """The GAT forward as one call of ``fn`` (a train step) launches it:
    the share of (source, target) pairs that are edges (the kernel walks
    only those, so its time depends on it), its out and alpha residual
    against the plain version's (``_gat_fwd_plain``, GAT_ATOL) and a
    rerun bit for bit, and the kernel's time and bound on those very
    inputs."""
    from ctvae_torch.ops import gat_flash as gf
    (args, kw), = _calls_of(gf, "flash_gat_cuda", fn)
    args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
    got, alpha = gf.flash_gat_cuda(*args, keep_alpha=True)
    again, alpha2 = gf.flash_gat_cuda(*args, keep_alpha=True)
    with torch.no_grad():
        want, want_alpha = _gat_fwd_plain(args)
    err = float((got - want).abs().max())
    alpha_err = float((alpha - want_alpha).abs().max())
    same = torch.equal(got, again) and torch.equal(alpha, alpha2)
    del got, again, alpha, alpha2, want, want_alpha
    torch.cuda.empty_cache()
    if not (err <= GAT_ATOL and alpha_err <= GAT_ATOL and same):
        raise AssertionError(f"gat_fwd on the step's inputs: out err {err}, "
                             f"alpha err {alpha_err}, rerun bit-identical "
                             f"{same}")
    bnd = _gat_fwd_bound(args, kw.get("keep_alpha", False))
    return {"edge_density": float(args[3].float().mean()),
            "shape": list(args[0].shape), "max_abs_err": err,
            "alpha_err": alpha_err, "bit_identical": same,
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
    from ctvae_torch.ops import launch_counts
    return launch_counts()


def _reset_counts() -> None:
    from ctvae_torch.ops import COUNTERS, set_launch_counts
    set_launch_counts({k: 0 for k in COUNTERS})


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


# the dense products' ops of the profile, attributed by input shape
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _profile(label: str, fn, gemm_shapes: bool = False) -> list:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the share of its wall time the card was busy (the profiler's ranges,
    such as ``Adam.step``'s, are logged apart: their time is that of
    kernels already counted); with ``gemm_shapes``
    then, over a second call profiled with ``record_shapes`` (whose host
    cost stays out of the busy share), the dense products by input shape:
    each ``GEMM_OPS`` op with the device time of the kernels it launched.
    Returns (kernel, ms, count) rows of the first call, longest first."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in device if not e.is_user_annotation),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile {label}: wall {wall:.3f} ms (profiled), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall), "
        f"{sum(r[2] for r in rows)} kernels; ranges " + ", ".join(
            f"{e.key} {e.self_device_time_total / 1e3:.3f} ms"
            for e in device if e.is_user_annotation))
    # the six longest, then the port's own kernels among the rest
    for i, (key, ms, count) in enumerate(rows):
        if i < 6 or re.search(r"namespace\)::(vq|pairwise|gat)_\w*kernel[<(]",
                              key):
            log(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")
    if not gemm_shapes:
        return rows
    with profile(activities=activities, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    gemms = sorted(((e.key, e.input_shapes, e.device_time_total / 1e3,
                     e.count)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key in GEMM_OPS), key=lambda r: -r[2])
    for key, shapes, ms, count in gemms[:8]:
        log(f"  gemm {ms:9.3f} ms  x{count:<3d} {key} "
            f"{json.dumps(shapes)} (a second call, record_shapes)")
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

def _train_setup(params=MODEL_PARAMS, B: int = BATCH):
    """The headline model (or ``params``) at batch ``B`` (16) with the
    config's exp_params: (model, train state, batch, a train step per
    mode)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    model = build_model(params, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(
        model, build_optimizers(EXP_PARAMS, model, steps_per_epoch=100),
        seed=SEED)
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 3), B, "cuda")
    batch = {"image": x, "input_y": y, "action": a}
    return model, state, batch, {m: make_train_step(m)
                                 for m in EXPECTED_TRAIN}


def _timed_steps(label: str, steps, state, batch, n: int, expected) -> dict:
    """``n`` train steps of each mode, each checked for its launches
    (``expected[mode]``) and a finite loss; returns {mode: median ms of
    the steps after the first, a warm-up}."""
    timings = {}
    for mode, step in steps.items():
        secs = []
        for _ in range(n):
            c0 = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            c1 = _counts()
            got = {k: c1[k] - c0[k] for k in c1}
            if got != expected[mode]:
                raise AssertionError(f"{label} {mode}: launches per step "
                                     f"{got}, expected {expected[mode]}")
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"{label} {mode}: loss {loss}")
        timed = [1e3 * t for t in secs[1:]]
        timings[mode] = statistics.median(timed)
        log(f"{label} {mode} B={BATCH}: {timings[mode]:.3f} ms per step "
            f"(median of {len(timed)} after a warm-up of "
            f"{1e3 * secs[0]:.3f}; min {min(timed):.3f}, max "
            f"{max(timed):.3f}); last loss {loss:.6g}, grad_norm "
            f"{float(metrics['grad_norm']):.6g}")
    return timings


def phase_train():
    """Train steps of each mode at the headline width, B = 16, with the
    config's exp_params; the launch counters are reset just before and
    read just after. Then one profiled step per mode."""
    model, state, batch, steps = _train_setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    timings = _timed_steps("train", steps, state, batch, TRAIN_STEPS,
                           EXPECTED_TRAIN)
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
                               lambda: step(state, batch), gemm_shapes=True)
                for mode, step in steps.items()}
    fwd = _gat_fwd_on_path(lambda: steps["causal"](state, batch))
    log(f"train causal: {_gat_fwd_text(fwd)}")
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
    for name in ("vq_l2_argmin", "gat_fwd", "gat_bwd", "pairwise_fwd",
                 "pairwise_bwd", "gat_logits_fwd", "gat_logits_bwd"):
        symbol = "vq_argmin" if name == "vq_l2_argmin" else name
        ms = sum(ms for key, ms, _ in profiles["causal"]
                 if f"{symbol}_kernel" in key)
        on_step.setdefault(name, {})["profiled_causal_step_ms"] = ms
        log(f"train causal: {name} {ms:.3f} ms of device time in the "
            f"profiled step")
    return timings, launches, peak, on_step


# --- phase 5b: the training slice past 120 latent sites -------------------

# the headline widths with codebooks: 2, as the CT search configs
# (configs_hyp/ct_mcq_vae_hyp_search_*.yaml) search it: the embedding of
# 128 over two codebooks of 64, S = 2 * 8 * 8 = 128 sites, 129 GAT nodes
C2_MODEL_PARAMS = {**MODEL_PARAMS, "codebooks": 2}
# launches per train step: each quantizer call searches both codebooks
EXPECTED_C2 = {m: {**e, "vq_l2_argmin": 2 * e["vq_l2_argmin"]}
               for m, e in EXPECTED_TRAIN.items()}


def _gat_fwd_text(m) -> str:
    return (f"GAT forward xl {m['shape']}, edge density "
            f"{m['edge_density']:.4f}: max abs err {m['max_abs_err']:.3g}, "
            f"alpha {m['alpha_err']:.3g}, rerun bit-identical "
            f"{m['bit_identical']}; kernel on these inputs {m['ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")


def _kernels_on_step(label: str, fn) -> dict:
    """Every kernel call but the VQ search's that one call of ``fn`` (a
    train step) makes, each held against the plain version on its own
    inputs and timed there: the pairwise and GAT forwards (out, and the
    GAT's alpha residual), the per-head logits forward and backward, and
    the pairwise and GAT backwards against the plain version's autograd
    (each gradient over its own scale, GRAD_RTOL). Each is logged under
    ``label``; returns them by kernel (``logits`` holds both of its)."""
    out = {"pairwise_fwd": _pairwise_fwd_on_path(fn)}
    for which, m in out["pairwise_fwd"].items():
        log(f"{label}: pairwise forward {which} {m['shape']}: max abs err "
            f"{m['max_abs_err']:.3g}, rerun bit-identical "
            f"{m['bit_identical']}; kernel on these inputs {m['ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
    m = out["gat_fwd"] = _gat_fwd_on_path(fn)
    log(f"{label}: {_gat_fwd_text(m)}")
    m = out["logits"] = _logits_on_path(fn)
    f, g = m["fwd"], m["bwd"]
    log(f"{label}: per-head logits forward {f['shape']}: max abs err "
        f"{f['max_abs_err']:.3g}, rerun bit-identical {f['bit_identical']}; "
        f"kernel on these inputs {f['ms']:.4f} ms, bound "
        f"{f['bound_ms']:.4f} ms ({f['bound_by']}); backward d_e "
        f"{g['shape']}, {g['live_share']:.4f} of pairs with a gradient: "
        f"errors {g['errors']}, rerun bit-identical {g['bit_identical']}; "
        f"kernel on these inputs {g['ms']:.4f} ms, bound "
        f"{g['bound_ms']:.4f} ms ({g['bound_by']})")
    out["pairwise_bwd"] = _pairwise_bwd_on_path(fn, check=True)
    for which, m in out["pairwise_bwd"].items():
        log(f"{label}: pairwise backward {which} {m['shape']}, live rows "
            f"{m['live_rows']:.4f}, pairs {m['live_pairs']:.4f}; kernel on "
            f"these inputs {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}); errors {m['errors']}; control (slope 1) "
            f"{m['control_errors']}")
    m = out["gat_bwd"] = _gat_bwd_on_path(fn)
    log(f"{label}: GAT backward xl {m['shape']}, edge density "
        f"{m['edge_density']:.4f}; errors {m['errors']}, rerun bit-identical "
        f"{m['bit_identical']}; kernel on these inputs {m['ms']:.4f} ms, "
        f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
    return out


def phase_codebooks_2():
    """A warm and a timed train step of each mode of the full-width
    ``codebooks: 2`` CT model at B = 16, the launch counters reset just
    before and read just after; then each mode's calls of every kernel but
    the VQ search (held at D = 64 in ``_check_vq``) against the plain
    version on their own inputs (``_kernels_on_step``); and one profiled
    causal step."""
    model, state, batch, steps = _train_setup(C2_MODEL_PARAMS)
    sites = C2_MODEL_PARAMS["codebooks"] * model.nb_latents ** 2
    if sites != 128:
        raise AssertionError(f"codebooks_2: {sites} latent sites, not 128")
    _reset_counts()
    timings = _timed_steps(f"codebooks_2 (S={sites}) train", steps, state,
                           batch, 2, EXPECTED_C2)
    launches = _counts()
    log(f"launches on the codebooks_2 path: {json.dumps(launches)}")
    found = {mode: _kernels_on_step(f"codebooks_2 {mode}",
                                    lambda: step(state, batch))
             for mode, step in steps.items()}
    _profile(f"codebooks_2 train step causal B={BATCH}",
             lambda: steps["causal"](state, batch), gemm_shapes=True)
    on_step = {k: {"codebooks_2": {m: v[k] for m, v in found.items()}}
               for k in ("pairwise_fwd", "gat_fwd", "pairwise_bwd",
                         "gat_bwd")}
    for which in ("fwd", "bwd"):
        on_step[f"gat_logits_{which}"] = {"codebooks_2": {
            m: v["logits"][which] for m, v in found.items()}}
    return timings, launches, on_step


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


# --- phase 8: the multi-step train step as a CUDA graph --------------------

SCAN_K = 8          # steps per make_multi_train_step call
SCAN_RTOL = 1e-6    # graph vs eager, over each tensor's largest magnitude
SCAN_ROUNDS = 5     # timed rounds of K eager steps and one K-step call


def _scan_tensors(state) -> dict:
    """Every parameter and Adam moment of a train state, by name."""
    out = {n: p.detach() for n, p in state.model.named_parameters()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for opt in state.optimizers:
        for p in opt.params:
            for k, v in opt.adam.state.get(p, {}).items():
                out[f"{names[id(p)]}:{k}"] = v
    return out


def phase_scan():
    """Per train mode at the headline widths, B = 16, the config's
    exp_params: 2K steps eagerly from one state and two
    ``make_multi_train_step(mode, K)`` calls from an equal state (equal
    weights and generator seed) on the same 2K batches; the warm-up steps
    run eagerly inside the first call, every later step replays the
    graph. Every parameter and Adam moment must agree within SCAN_RTOL of
    its largest magnitude, the generator states, steps and optimizer
    counts exactly. Then SCAN_ROUNDS rounds, in turns, of K eager steps
    and one K-step call, timed from the host clock to the device's end.
    Returns (the kernels' launches by the replays, ms per step)."""
    from ctvae_torch.training import make_multi_train_step
    from ctvae_torch.training.state import WARMUP_STEPS
    launches, timings = {k: 0 for k in EXPECTED_TRAIN["base"]}, {}
    gen = torch.Generator().manual_seed(SEED + 5)
    for mode, expected in EXPECTED_TRAIN.items():
        _, eager, _, steps = _train_setup()
        _, graph, _, _ = _train_setup()
        xs = [_requests(gen, BATCH, "cuda") for _ in range(2 * SCAN_K)]
        stacked = {k: torch.stack([r[i] for r in xs])
                   for i, k in enumerate(("image", "input_y", "action"))}
        step, multi = steps[mode], make_multi_train_step(mode, SCAN_K)
        for i in range(2 * SCAN_K):
            want = step(eager, {k: v[i] for k, v in stacked.items()})
        for half in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K)):
            got = multi(graph, {k: v[half] for k, v in stacked.items()})
        torch.cuda.synchronize()
        if multi.replays != 2 * SCAN_K - WARMUP_STEPS:
            raise AssertionError(f"scan {mode}: {multi.replays} replays")
        a, b = _scan_tensors(eager), _scan_tensors(graph)
        if a.keys() != b.keys():
            raise AssertionError(f"scan {mode}: tensors {set(a) ^ set(b)}")
        diffs = {n: float((a[n].float() - b[n].float()).abs().max())
                 for n in a}
        bad = {n: d for n, d in diffs.items() if d > SCAN_RTOL * max(
            float(a[n].float().abs().max()), 1e-30)}
        same_gen = torch.equal(eager.generator.get_state(),
                               graph.generator.get_state())
        counts = ([o.count for o in eager.optimizers],
                  [o.count for o in graph.optimizers])
        log(f"scan {mode}: {len(diffs)} parameters and Adam moments after "
            f"{2 * SCAN_K} steps, eager vs {multi.replays} graph replays "
            f"(after {WARMUP_STEPS} warm-up steps): "
            f"{sum(d == 0 for d in diffs.values())} bit-equal, largest abs "
            f"difference {max(diffs.values()):.3g}; generator equal "
            f"{same_gen}, step {eager.step} / {graph.step}, optimizer "
            f"counts {counts[0]} / {counts[1]}; last loss "
            f"{float(want['loss']):.6g} / {float(got['loss']):.6g}")
        log(f"scan {mode}: max abs difference by tensor "
            f"{json.dumps({n: float(f'{d:.3g}') for n, d in diffs.items()})}")
        if bad or not same_gen or eager.step != graph.step or \
                counts[0] != counts[1]:
            raise AssertionError(f"scan {mode}: graph and eager steps "
                                 f"disagree: {bad}, generator {same_gen}")
        per_replay = {k: n // multi.replays
                      for k, n in multi.replayed_launches().items()}
        if per_replay != expected:
            raise AssertionError(f"scan {mode}: launches per replay "
                                 f"{per_replay}, expected {expected}")
        for k, n in multi.replayed_launches().items():
            launches[k] += n
        secs = {"eager": [], "graph": []}
        batches = {k: v[:SCAN_K] for k, v in stacked.items()}

        def run_eager():
            for i in range(SCAN_K):
                step(eager, {k: v[i] for k, v in batches.items()})

        runs = {"eager": run_eager, "graph": lambda: multi(graph, batches)}
        for r in range(SCAN_ROUNDS):
            for which in (("eager", "graph") if r % 2 == 0
                          else ("graph", "eager")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[which]()
                torch.cuda.synchronize()
                secs[which].append(1e3 * (time.perf_counter() - t0) / SCAN_K)
        timings[mode] = {w: statistics.median(t) for w, t in secs.items()}
        log(f"scan {mode} B={BATCH}: eager {timings[mode]['eager']:.3f} ms "
            f"per step, graph replay {timings[mode]['graph']:.3f} ms per "
            f"step (medians of {SCAN_ROUNDS} rounds of {SCAN_K} steps in "
            f"turns; eager {json.dumps([round(t, 3) for t in secs['eager']])}"
            f", graph {json.dumps([round(t, 3) for t in secs['graph']])})")
    log(f"launches of the scan path (captured x replays): "
        f"{json.dumps(launches)}")
    return launches, timings


# --- phase 9: the port's bench ---------------------------------------------

BENCH_KEYS = ("device", "config", "dtype", "ct_action_img_per_sec") + tuple(
    f"ct_{m}_{k}" for m in EXPECTED_TRAIN
    for k in ("ms_per_step", f"ms_per_step_scan{SCAN_K}",
              "device_ms_per_step", "launches_per_step", "step_mfu")) + tuple(
    f"serve_{e}_ms" for e in ("reconstruct", "encode", "apply_action",
                              "classify_action"))


def _check_bench_batch() -> None:
    """One base and one action step of the headline model at the bench's
    batch (128), every kernel call of each held against the plain version
    on its own inputs (``_vq_on_path``, ``_kernels_on_step``)."""
    from ctvae_torch.bench import BATCH as B
    _, state, batch, steps = _train_setup(MODEL_PARAMS, B)
    for mode in ("base", "action"):
        step = steps[mode]
        vq = _vq_on_path(lambda: step(state, batch))
        log(f"bench batch {mode} B={B}: VQ search {json.dumps(vq)}")
        _kernels_on_step(f"bench batch {mode} B={B}",
                         lambda: step(state, batch))
    del state, batch, steps
    torch.cuda.empty_cache()


def phase_bench() -> dict:
    """The kernels at the bench's batch (``_check_bench_batch``); then
    ``python -m ctvae_torch.bench --blocks 2`` at its default config
    (``configs/ct_mcq_vae.yaml``): its output, then its last line checked
    (at most 1,500 characters, every key, every ``mfu`` in (0, 1])."""
    t0 = time.perf_counter()
    _check_bench_batch()
    log(f"bench batch: every kernel call of a base and an action step held "
        f"against the plain version in {time.perf_counter() - t0:.1f} s")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ctvae_torch.bench",
                           "--blocks", "2"], cwd=root, capture_output=True,
                          text=True, timeout=900)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[:-1]:
        log(f"bench| {line}")
    if proc.returncode != 0:
        raise AssertionError(f"ctvae_torch.bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    last = proc.stdout.splitlines()[-1]
    result = json.loads(last)
    missing = [k for k in BENCH_KEYS if k not in result]
    mfu = {m: result.get(f"ct_{m}_step_mfu") for m in EXPECTED_TRAIN}
    if len(last) > 1500 or missing or not all(
            v is not None and 0 < v <= 1 for v in mfu.values()):
        raise AssertionError(f"bench line: {len(last)} characters, missing "
                             f"{missing}, mfu {mfu}")
    log(f"bench: {secs:.1f} s, last line {len(last)} characters")
    log(last)
    return result


# --- phase 10: the headline configs from their YAML on Shapes3D -----------

# a Shapes3D stand-in on a grid that keeps all six factors (so the CT
# config's action_dim 12 holds): 30,720 images, 377 MB of uint8
SHAPES3D_GRID = (4, 4, 4, 8, 4, 15)
SHAPES3D_LIMIT = 112       # per mode: 7 TShapes3D train batches of 16
SHAPES3D_VAL_LIMIT = 64    # per mode: 4 validation batches of 16
LOADER_BATCHES = 20        # batches timed out of each config's loader
SHAPES3D_EPOCH_BATCHES = 96   # steps of each epoch timed in turns


def _headline_config(name: str, root: str, logs: str) -> dict:
    """``configs/<name>.yaml`` as ``read_config`` reads it, with the data
    path, the limits, one epoch and the log directory changed."""
    cfg = read_config(os.path.join(os.path.dirname(CONFIG), f"{name}.yaml"))
    cfg["data_params"] = {**cfg["data_params"], "data_path": root,
                          "limit": SHAPES3D_LIMIT,
                          "val_limit": SHAPES3D_VAL_LIMIT}
    cfg["trainer_params"] = {**cfg["trainer_params"], "max_epochs": 1}
    cfg["logging_params"] = {**cfg["logging_params"], "save_dir": logs}
    return cfg


def _loader_ms(data) -> tuple:
    """Host ms per batch out of ``data``'s train loader (the schedule,
    ``get_batch`` and the transform), and ms of the pinned copy of each
    to the card (``data/prefetch.py::to_device``, synchronised): medians
    over ``LOADER_BATCHES`` batches; and one batch of each mode."""
    from ctvae_torch.data import TransitionDataset
    from ctvae_torch.data.prefetch import to_device
    ds = data.train_dataset
    modes = (set(ds.mode_ranges()) if isinstance(ds, TransitionDataset)
             else {"base"})
    host, copy, batches = [], [], {}
    it = iter(data.train_dataloader(0))
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        mode = batch.pop("mode")
        if len(host) < LOADER_BATCHES:
            host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches[mode] = to_device(batch, "cuda")
            torch.cuda.synchronize()
            copy.append(1e3 * (time.perf_counter() - t0))
        elif set(batches) == modes:
            break
        else:       # a mode the timed batches did not bring
            batches.setdefault(mode, to_device(batch, "cuda"))
    return statistics.median(host), statistics.median(copy), batches


def _threaded(batches, depth: int = 2):
    """``batches`` assembled ``depth`` ahead on a host thread that runs
    torch's CPU ops on one thread of its own (set once as it starts): the
    prefetch design the port does not take, timed against its inline
    loader. An error of the thread is raised here."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    threads = torch.get_num_threads()

    def worker():
        try:
            torch.set_num_threads(1)
            for b in batches:
                q.put(b)
            q.put(None)
        except BaseException as e:          # raised again in the consumer
            q.put(e)
        finally:
            torch.set_num_threads(threads)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while (b := q.get()) is not None:
        if isinstance(b, BaseException):
            raise b
        yield b
    thread.join()


class _EpochOf:
    """A data module over the first ``n`` train batches of ``data``, given
    to the loop one of three ways: ``held``, replayed from a list built
    beforehand (the loader's work taken out of the epoch); ``inline``,
    assembled by the loop's own thread as the port does; ``thread``,
    assembled ahead on a host thread (``_threaded``)."""

    def __init__(self, data, n: int, how: str):
        import itertools
        self.n, self.how = n, how
        self.batches = lambda: itertools.islice(data.train_dataloader(0), n)
        self.held = list(self.batches()) if how == "held" else None

    def train_dataloader(self, epoch: int = 0):
        if self.how == "held":
            return (dict(b) for b in self.held)
        return (_threaded(self.batches()) if self.how == "thread"
                else self.batches())

    def steps_per_epoch(self) -> int:
        return self.n


def _epoch_ms(model, exp_params: dict, data, B: int) -> float:
    """ms per step of one ``VAEXperiment.train_epoch`` over ``data`` on
    ``model`` (fresh optimizers)."""
    from ctvae_torch.training import VAEXperiment
    experiment = VAEXperiment(model, exp_params, data)
    experiment.setup(seed=SEED)
    return 1e3 * B / experiment.train_epoch(0)["images_per_sec"]


def _check_run(label: str, cfg: dict, out: dict, logs: str) -> str:
    """A run's metrics finite, and in its ``version_0``: the checkpoints,
    ``scalars.jsonl`` lines, valid image grids. Returns the run's dir."""
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    run_dir = os.path.join(logs, cfg["logging_params"]["name"], "version_0")
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    name = cfg["model_params"]["name"]
    pngs = [os.path.join(run_dir, sub, f"{prefix}{name}_Epoch_0.png")
            for sub, prefix in (("Inputs", "real_img_"),
                                ("Reconstructions", "recons_"),
                                ("Samples", ""))]
    invalid = [p for p in pngs if not _valid_png(p)]
    if bad or "last" not in ckpts or not any(
            c.startswith("step_") for c in ckpts) or not scalars or invalid:
        raise AssertionError(f"{label}: non-finite {bad}, checkpoints "
                             f"{ckpts}, {len(scalars)} scalar lines, "
                             f"invalid PNGs {invalid}")
    log(f"{label}: checkpoints {ckpts}; {len(scalars)} lines in "
        f"scalars.jsonl; Inputs, Reconstructions and Samples PNGs valid")
    return run_dir


def phase_shapes3d() -> tuple:
    """The two headline configs from their own YAML through the port's
    entry points, on a Shapes3D stand-in written by the port's writer
    (numpy only) with its split and transition files: ``run.train`` of
    ``configs/mcq_vae.yaml`` (Shapes3D, B = 64, ``codebooks: 4``: a full
    epoch of the stand-in's train split, since ``limit`` cuts transition
    datasets only) and of ``configs/ct_mcq_vae.yaml`` (TShapes3D, B = 16,
    7 batches per mode), then ``apply_action`` on the CT run's checkpoint.
    The launch counters are reset before each run and read after it (the
    CT path includes ``apply_action``). Then, for both configs on a model
    of their own: the loader's host ms per batch and the copy's ms, train
    steps timed on real batches, every VQ search call of each mode's step
    (the MCQVAE's base, the CT model's base, action and causal) held
    against the plain version (``_vq_on_path``) and every other kernel
    call of the CT steps too (``_kernels_on_step``); and the epoch's first
    ``SHAPES3D_EPOCH_BATCHES`` steps in turns three ways (``_EpochOf``),
    which give the loader's share of the epoch. Returns the two paths'
    launches and the checks on the steps."""
    import tempfile
    from ctvae_torch import run
    from ctvae_torch.apply_action import apply_action
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.data.standins import write_shapes3d_standin
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)

    start, threads = time.perf_counter(), torch.get_num_threads()
    with tempfile.TemporaryDirectory(prefix="ctvae_shapes3d_") as tmp:
        root, logs = os.path.join(tmp, "Data"), os.path.join(tmp, "logs")
        t0 = time.perf_counter()
        npz = write_shapes3d_standin(root, SHAPES3D_GRID)
        mb = os.path.getsize(npz) / 1e6
        log(f"shapes3d: stand-in {SHAPES3D_GRID} written in "
            f"{time.perf_counter() - t0:.2f} s ({mb:.1f} MB npz, split and "
            f"variation_attrs_6.txt of that grid)")

        cfgs = {name: _headline_config(name, root, logs)
                for name in ("mcq_vae", "ct_mcq_vae")}
        paths, outs, run_dirs = {}, {}, {}
        for name, cfg in cfgs.items():
            _reset_counts()
            t0 = time.perf_counter()
            out = outs[name] = run.train(cfg, device="cuda")
            secs = time.perf_counter() - t0
            run_dirs[name] = _check_run(f"shapes3d {name}", cfg, out, logs)
            if name == "ct_mcq_vae":
                steps = {m: int(out.get(f"train_steps_{m}", 0))
                         for m in EXPECTED_TRAIN}
                if set(steps.values()) != {SHAPES3D_LIMIT // BATCH}:
                    raise AssertionError(f"shapes3d ct: mode mix {steps}")
                res = apply_action(cfg, os.path.join(
                    run_dirs[name], "checkpoints", "last"),
                    out=os.path.join(tmp, "images"), steps=2, device="cuda")
                torch.cuda.synchronize()
                bad = [p for p in res["images"] if not _valid_png(p)]
                if len(res["images"]) != 1 + 2 * 12 or bad or not (
                        res["causal_batches"]
                        and math.isfinite(res["causal_acc"])
                        and math.isfinite(res["causal_nodir_acc"])):
                    raise AssertionError(f"shapes3d apply_action: "
                                         f"{len(res['images'])} PNGs "
                                         f"({len(bad)} invalid), {res}")
                log(f"shapes3d apply_action: {len(res['images'])} valid "
                    f"PNGs; causal sweep {res['causal_acc']:.4f} "
                    f"({res['causal_nodir_acc']:.4f} undirected) over "
                    f"{res['causal_batches']} batches")
            paths[name] = _counts()
            log(f"shapes3d {name}: run.train of the YAML in {secs:.2f} s; "
                f"train loss {out['train_loss']:.6g}, val loss "
                f"{out['val_loss']:.6g}, epoch images/s "
                f"{out['train_images_per_sec']:.1f}")
            log(f"launches on the shapes3d {name} path: "
                f"{json.dumps(paths[name])}")

        # the loader, the copy and the step, each on its own; then every
        # kernel call of each mode's step held against its plain version;
        # then the epoch three ways in turns
        pace, on_step = {}, {"vq_l2_argmin": {"shapes3d": {}}}
        for name, cfg in cfgs.items():
            data = VAEDataset(**cfg["data_params"])
            data.setup()
            host_ms, copy_ms, batches = _loader_ms(data)
            exp = cfg["exp_params"]
            model = build_model(cfg["model_params"], device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(SEED))
            state = create_train_state(
                model, build_optimizers(exp, model, steps_per_epoch=100),
                seed=SEED)
            modes = ("base",) if name == "mcq_vae" else tuple(EXPECTED_TRAIN)
            B = cfg["data_params"]["train_batch_size"]
            step_ms = {}
            for mode in modes:
                step, batch = make_train_step(mode), batches[mode]
                secs = []
                for _ in range(TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss = float(step(state, batch)["loss"])
                    secs.append(1e3 * (time.perf_counter() - t0))
                    if not math.isfinite(loss):
                        raise AssertionError(f"shapes3d {name} {mode}: loss "
                                             f"{loss}")
                step_ms[mode] = statistics.median(secs[1:])
            found = {}
            for mode in modes:
                def run_step(mode=mode):
                    return make_train_step(mode)(state, batches[mode])
                vq = _vq_on_path(run_step)
                if not vq:
                    raise AssertionError(f"shapes3d {name} {mode}: no VQ call")
                row = {"calls": len(vq),
                    "x": sorted({tuple(c["x"]) for c in vq}),
                    "differ": sum(c["differ"] for c in vq),
                    "near_ties": sum(c["near_ties"] for c in vq),
                    "max_distance_gap": max(c["max_distance_gap"]
                                            for c in vq),
                    "bit_identical": all(c["bit_identical"] for c in vq),
                    "ms": statistics.median(c["ms"] for c in vq),
                    "plain_ms": statistics.median(c["plain_ms"] for c in vq),
                    "library_ms": statistics.median(c["library_ms"]
                                                    for c in vq),
                    "bound_ms": vq[0]["bound_ms"],
                    "bound_by": vq[0]["bound_by"]}
                on_step["vq_l2_argmin"]["shapes3d"][f"{name} {mode}"] = row
                log(f"shapes3d {name} {mode} B={B}: VQ search "
                    f"{json.dumps(row)}")
                if name == "ct_mcq_vae":
                    found[mode] = _kernels_on_step(f"shapes3d {mode}",
                                                   run_step)
            if found:
                for k in ("pairwise_fwd", "gat_fwd", "pairwise_bwd",
                          "gat_bwd"):
                    on_step[k] = {"shapes3d": {m: v[k]
                                               for m, v in found.items()}}
                for which in ("fwd", "bwd"):
                    on_step[f"gat_logits_{which}"] = {"shapes3d": {
                        m: v["logits"][which] for m, v in found.items()}}
            # the epoch in turns (ABCCBA): its batches held, assembled
            # ahead on a host thread, assembled inline as the port does
            n = min(SHAPES3D_EPOCH_BATCHES, data.steps_per_epoch())
            ways = {how: _EpochOf(data, n, how)
                    for how in ("held", "thread", "inline")}
            turns = {how: [] for how in ways}
            for how in ("held", "thread", "inline", "inline", "thread",
                        "held"):
                turns[how].append(_epoch_ms(model, exp, ways[how], B))
            ms = {how: statistics.mean(v) for how, v in turns.items()}
            # what the loader adds to the epoch the port runs
            share = (ms["inline"] - ms["held"]) / ms["inline"]
            paced_by = ("step" if share < 0.1 else "loader"
                        if host_ms > ms["held"] else "step and loader")
            epoch_ms = 1e3 * B / outs[name]["train_images_per_sec"]
            pace[name] = {"loader_host_ms_per_batch": host_ms,
                          "copy_ms_per_batch": copy_ms,
                          "train_ms_per_step": step_ms,
                          "run_epoch_ms_per_step": epoch_ms,
                          "epoch_batches": n,
                          "epoch_ms_per_step": turns,
                          "loader_share": share,
                          "thread_gain_ms_per_step":
                              ms["inline"] - ms["thread"],
                          "epoch_images_per_sec":
                              outs[name]["train_images_per_sec"],
                          "paced_by": paced_by}
            rounded = {m: round(v, 3) for m, v in step_ms.items()}
            log(f"shapes3d {name} B={B}: loader {host_ms:.3f} ms per batch "
                f"on the host (schedule, get_batch, transform; median of "
                f"{LOADER_BATCHES}), pinned copy {copy_ms:.3f} ms, train "
                f"step {json.dumps(rounded)} ms (median of "
                f"{TRAIN_STEPS - 1} after a warm-up); run.train's epoch "
                f"{epoch_ms:.3f} ms per step "
                f"({outs[name]['train_images_per_sec']:.1f} images/s); "
                f"{n} steps in turns, ms per step: batches held "
                f"{ms['held']:.3f}, a loader thread {ms['thread']:.3f}, "
                f"inline {ms['inline']:.3f}: the loader takes "
                f"{100 * share:.1f}% of the inline epoch, the thread "
                f"saves {ms['inline'] - ms['thread']:.3f} ms per step; "
                f"pace set by the {paced_by}")
            del model, state, batches, ways
    log(json.dumps({"shapes3d_pace": pace}))
    # the loop's thread keeps its torch CPU threads
    if torch.get_num_threads() != threads:
        raise AssertionError(f"shapes3d: torch threads {threads} -> "
                             f"{torch.get_num_threads()}")
    log(f"shapes3d: phase {time.perf_counter() - start:.2f} s (torch CPU "
        f"threads of the main thread: {threads})")
    return paths["mcq_vae"], paths["ct_mcq_vae"], on_step


# --- phase 11: the disentanglement metrics ---------------------------------

METRIC_NAMES = ["DCI", "MIG", "SAP", "FactorVaeScore"]
METRIC_KEYS = ("dci.disentanglement", "dci.completeness",
               "dci.informativeness_train", "dci.informativeness_test",
               "mig.discrete_score", "sap.score",
               "factor_vae.mean_accuracy", "factor_vae.eval_accuracy",
               "factor_vae.num_active_dims")
# the metrics' sample sizes at the headline configs (run.py: 20 / 10 train
# batches, batches of val_batch_size): ct_mcq_vae B = 16, mcq_vae B = 64
METRIC_SIZES = {"ct_mcq_vae": (16, 320, 160), "mcq_vae": (64, 1280, 640)}
# the card against the CPU on one table of codes, cut to the dims of
# largest variance (CPU torch at D = 8,192 is slow; most codes of a
# briefly trained encoder are nearly constant), DCI at this many rounds
CPU_DIMS, CPU_ESTIMATORS = 256, 10
# card against CPU: MIG to rounding of the logs, SAP to rounding of the
# mean accuracies (the SVMs' predictions must be equal), FactorVAE
# exactly (counts of votes), DCI's four numbers within DCI_TOL (the
# trees' cumulative sums round in another order on the card; a split
# that differs is printed)
MIG_TOL, SAP_TOL, DCI_TOL = 1e-12, 1e-12, 1e-6


class _TableSampler:
    """The metrics' sampler over a table of codes of every grid image:
    observations are the rows' indices, so ``repr_fn`` is a lookup and
    the card and the CPU see the same codes."""

    def __init__(self, dataset, seed: int = 0):
        import numpy as np
        self.ds = dataset
        self.factor_sizes = tuple(dataset.factor_sizes)
        self.rng = np.random.default_rng(seed)

    def sample_factors(self, n: int):
        import numpy as np
        return np.stack([self.rng.integers(0, s, n)
                         for s in self.factor_sizes], axis=1)

    def observations_from_factors(self, factors):
        return self.ds.factor_to_index(factors)

    def sample(self, n: int):
        f = self.sample_factors(n)
        return f, self.observations_from_factors(f)


def _code_table(full, repr_fn, dims: int, chunk: int = 512) -> torch.Tensor:
    """The ``dims`` codes of largest variance over every image of the
    grid, on the card."""
    rows = []
    for lo in range(0, len(full.images_raw), chunk):
        raw = full.images_raw[lo:lo + chunk]
        rows.append(repr_fn(full.transform.batch(raw)))
    table = torch.cat(rows)
    keep = torch.topk(table.var(0), dims).indices.sort().values
    return table[:, keep].contiguous()


def _gbt_splits_differ(z_dev, z_cpu, f, est: int) -> list:
    """Each factor's trees fitted on the card and on the CPU: the splits
    (round, tree, node) whose feature or threshold differ."""
    from ctvae_torch.metrics.gbt import fit_gbt
    out = []
    for j in range(f.shape[1]):
        y = torch.as_tensor(f[:, j])
        a = fit_gbt(z_dev, y.cuda(), n_estimators=est)
        b = fit_gbt(z_cpu, y, n_estimators=est)
        fa, fb = a.feature.cpu(), b.feature
        ta, tb = a.threshold.cpu(), b.threshold
        bad = ((fa != fb) | ((ta - tb).abs() > 1e-6)).nonzero().tolist()
        out += [{"factor": j, "round": r, "tree": k, "node": h,
                 "card": [int(fa[r, k, h]), float(ta[r, k, h])],
                 "cpu": [int(fb[r, k, h]), float(tb[r, k, h])]}
                for r, k, h in bad]
    return out


def phase_metrics(smi: str) -> tuple:
    """The disentanglement metrics through the port's entry point and on
    the card. (1) ``run.train`` of ``configs/ct_mcq_vae.yaml`` on a
    Shapes3D stand-in (phase "shapes3d"'s grid and limits, one epoch)
    with ``exp_params.metrics`` = DCI, MIG, SAP, FactorVaeScore: the
    epoch's kernels launched, the metrics' ``val_`` keys finite in the
    result and in ``scalars.jsonl``. (2) Each metric timed on the card at
    both headline configs' sample sizes, through the trained encoder (D =
    8,192), and one DCI fit profiled (its largest device ops). (3) One
    table of codes of the grid (its ``CPU_DIMS`` of largest variance), the
    four metric functions on it on the card and on the CPU, held at the
    stated tolerances, with the SVMs' coefficients and the trees' splits
    compared.
    Returns the launches of (1) and the seconds of (2)."""
    import tempfile
    import numpy as np
    from ctvae_torch import run
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.data.standins import write_shapes3d_standin
    from ctvae_torch.metrics import GroundTruthSampler, Metric
    from ctvae_torch.metrics import disentanglement as dis
    from ctvae_torch.metrics.disentanglement import _collect
    from ctvae_torch.metrics.gbt import fit_gbt
    from ctvae_torch.metrics.linear_svc import (fit_linear_svc,
                                                predict_linear_svc)
    from ctvae_torch.models import build_model
    from ctvae_torch.training import make_repr_fn
    from ctvae_torch.utils.checkpoint import load_weights_only

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ctvae_metrics_") as tmp:
        root, logs = os.path.join(tmp, "Data"), os.path.join(tmp, "logs")
        write_shapes3d_standin(root, SHAPES3D_GRID)
        cfg = _headline_config("ct_mcq_vae", root, logs)
        cfg["exp_params"] = {**cfg["exp_params"], "metrics": METRIC_NAMES}
        _reset_counts()
        t0 = time.perf_counter()
        out = run.train(cfg, device="cuda")
        secs = time.perf_counter() - t0
        launches = _counts()
        run_dir = _check_run("metrics ct_mcq_vae", cfg, out, logs)
        logged = {}
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            for line in f:
                logged.update(json.loads(line))
        vals = {k: out.get("val_" + k) for k in METRIC_KEYS}
        if any(v is None or not math.isfinite(v) for v in vals.values()) \
                or any("val_" + k not in logged for k in METRIC_KEYS):
            raise AssertionError(f"metrics: val_ keys {vals}, logged "
                                 f"{sorted(k for k in logged if '.' in k)}")
        log(f"metrics: run.train of ct_mcq_vae with exp_params.metrics "
            f"{METRIC_NAMES} in {secs:.2f} s: {json.dumps(vals)}")
        log(f"launches on the metrics path: {json.dumps(launches)}")

        # (2) each metric at both configs' sizes, through the encoder
        model = build_model(cfg["model_params"], device="cuda")
        load_weights_only(os.path.join(run_dir, "checkpoints", "last"),
                          model)
        repr_fn = make_repr_fn(model)
        data = VAEDataset(**cfg["data_params"])
        data.setup()
        full = data.val_dataset._full_data
        D = int(repr_fn(full.transform.batch(full.images_raw[:1])).shape[1])
        seconds = {}
        for name, (B, n_tr, n_te) in METRIC_SIZES.items():
            seconds[name] = {}
            for metric in METRIC_NAMES:
                m = Metric(metric, full, batch_size=B, num_train=n_tr,
                           num_test=n_te)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = m.compute(repr_fn)
                torch.cuda.synchronize()
                seconds[name][metric] = time.perf_counter() - t0
                if not all(math.isfinite(v) for v in res.values()):
                    raise AssertionError(f"metrics {name} {metric}: {res}")
            log(f"metrics at {name}'s sizes (B = {B}, {n_tr} / {n_te} "
                f"samples, D = {D}), seconds on the card: "
                f"{json.dumps(seconds[name])}; {smi}")

        # one DCI fit profiled: device time by kernel at mcq_vae's sizes,
        # on the factor of most classes, 5 rounds
        B, n_tr, _ = METRIC_SIZES["mcq_vae"]
        f_tr, z_tr = _collect(GroundTruthSampler(full), repr_fn, n_tr, B)
        j = int(np.argmax(full.factor_sizes))
        y = torch.as_tensor(f_tr[:, j], device="cuda")
        fit_gbt(z_tr, y, n_estimators=1)
        _profile(f"DCI fit_gbt, {n_tr} x {D} codes, factor {j} "
                 f"({full.factor_sizes[j]} classes), 5 rounds",
                 lambda: fit_gbt(z_tr, y, n_estimators=5))

        # (3) the card against the CPU on one table of codes
        table = _code_table(full, repr_fn, CPU_DIMS)
        tables = {"cuda": table, "cpu": table.cpu()}
        kw = dict(num_train=320, num_test=160, batch_size=16)
        res = {}
        for dev, tab in tables.items():
            fn = (lambda idx, tab=tab: tab[torch.as_tensor(idx,
                                                           device=tab.device)])
            res[dev] = {
                **dis.metric_mig(_TableSampler(full), fn, num_train=320,
                                 batch_size=16),
                **dis.metric_sap(_TableSampler(full), fn, **kw),
                **dis.metric_dci(_TableSampler(full), fn,
                                 n_estimators=CPU_ESTIMATORS, **kw),
                **dis.metric_factor_vae(_TableSampler(full), fn,
                                        num_train=320, num_eval=160,
                                        batch_size=16)}
        f_tr, z_tr = _collect(_TableSampler(full),
                              lambda idx: tables["cpu"][idx], 320, 16)
        svc = {}
        for j in range(f_tr.shape[1]):
            y = torch.as_tensor(f_tr[:, j])
            a = fit_linear_svc(z_tr.cuda(), y.cuda())
            b = fit_linear_svc(z_tr, y)
            svc[j] = {"coef": float((a.coef.cpu() - b.coef).abs().max()),
                      "intercept": float((a.intercept.cpu()
                                          - b.intercept).abs().max()),
                      "predictions_differ": int(
                          (predict_linear_svc(a, z_tr.cuda()).cpu()
                           != predict_linear_svc(b, z_tr)).sum())}
        splits = _gbt_splits_differ(z_tr.cuda(), z_tr, f_tr, CPU_ESTIMATORS)
        diff = {k: abs(res["cuda"][k] - res["cpu"][k]) for k in METRIC_KEYS}
        log(f"metrics card vs CPU on the {CPU_DIMS} codes of largest "
            f"variance of the {len(full.images_raw)} grid images: card "
            f"{json.dumps(res['cuda'])}; CPU {json.dumps(res['cpu'])}; "
            f"|difference| "
            f"{json.dumps(diff)}; SVC coef / intercept differences and "
            f"train predictions that differ per factor {json.dumps(svc)}; "
            f"{len(splits)} tree splits differ")
        for sp in splits:
            log(f"  split differs: {json.dumps(sp)}")
        tol = {"mig": MIG_TOL, "sap": SAP_TOL, "dci": DCI_TOL,
               "factor_vae": 0.0}
        bad = [k for k in METRIC_KEYS if diff[k] > tol[k.split(".")[0]]]
        if bad or any(v["predictions_differ"] for v in svc.values()):
            raise AssertionError(f"metrics card vs CPU: {bad} {svc}")
        del model, table, tables
    log(f"metrics: phase {time.perf_counter() - start:.2f} s")
    return launches, seconds


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


def _builds(stem: str, tree, sources, setup) -> dict:
    """{"tree": the tree's library, source: its build for each of
    ``sources``}, each library's entry points typed by ``setup(lib)``."""
    libs = {"tree": tree, **_build_others(stem, sources)}
    for lib in libs.values():
        setup(lib)
    return libs


def _step_calls(module, name: str, params=MODEL_PARAMS, tag: str = ""
                ) -> dict:
    """{"<tag><mode>_<n>": args}: the arguments (tensors detached) of the
    n-th call of ``module.name`` in one train step of each mode of the
    model of ``params``."""
    _, state, batch, steps = _train_setup(params)
    found = {}
    for mode, step in steps.items():
        calls = _calls_of(module, name, lambda: step(state, batch))
        for n, (args, _) in enumerate(calls):
            found[f"{tag}{mode}_{n}"] = tuple(
                a.detach() if torch.is_tensor(a) else a for a in args)
    return found


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


# rounds of a paired comparison: enough for a gain of ~1% to win most of
# them against the ~1% spread between calls
PAIRED_ROUNDS = 11


def _paired_times(res, libs, key: str, launch) -> None:
    """Into ``res[name]`` for each build: over PAIRED_ROUNDS rounds of
    ``time_ms`` of ``launch(lib)``, the builds in turns, the median
    (``ms_<key>``), the median ratio of its sample to the tree's sample of
    the same round (``vs_tree_<key>``: below 1 is faster than the tree),
    the rounds it was faster and the samples; on the B = 16 dense inputs
    also the host's microseconds per launch call (``host_us_<key>``)."""
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


def _compare(stem: str, libs, inputs, launch, agree, describe,
             plain=lambda args: None, timed=None, occupancy=None,
             prefix: str = "") -> dict:
    """Each build of ``libs`` launched raw (``launch(lib, args)``: its
    outputs, a list) twice on each of ``inputs`` ({key: args}): its
    outputs against the tree's (``max_diff``, ``bit_identical``), against
    its own rerun (``rerun_identical``) and against ``want = plain(args)``
    by ``agree(args, got, want)`` (a dict); then ``_paired_times`` of
    ``timed`` (else ``launch``). A build that refuses an input (an earlier
    one past its shared memory) is recorded (``refused``) and left out of
    that input's rounds. Every key ends in ``_<prefix><input key>``; the
    builds also get ``occupancy(lib)`` (where the build exports it).
    Returns {"inputs": {key: describe(args)}, "builds": {name: {...}}}."""
    res, shapes = {name: {} for name in libs}, {}
    for key, args in inputs.items():
        key = prefix + key
        shapes[key] = describe(args)
        want = plain(args)
        outs = {}
        for name, lib in libs.items():
            try:
                outs[name] = (launch(lib, args), launch(lib, args))
            except RuntimeError as e:
                res[name][f"refused_{key}"] = str(e)
        torch.cuda.synchronize()
        tree = outs["tree"][0]
        for name, (got, again) in outs.items():
            r = res[name]
            r[f"max_diff_{key}"] = max(float((g - w).abs().max())
                                       for g, w in zip(got, tree))
            r[f"bit_identical_{key}"] = all(
                torch.equal(g, w) for g, w in zip(got, tree))
            r[f"rerun_identical_{key}"] = all(
                torch.equal(g, h) for g, h in zip(got, again))
            r.update({f"{k}_{key}": v
                      for k, v in agree(args, got, want).items()})
        del want, outs, tree
        torch.cuda.empty_cache()
        _paired_times(res, {n: lib for n, lib in libs.items()
                            if f"refused_{key}" not in res[n]}, key,
                      lambda lib: (timed or launch)(lib, args))
        log(f"{stem} inputs {key}: {json.dumps(shapes[key])}")
    for name, lib in libs.items():
        try:
            res[name].update(occupancy(lib) if occupancy else {})
        except AttributeError:
            pass
        log(f"{stem} {name}: {json.dumps(res[name])}")
    return {"inputs": shapes, "builds": res}


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


def _gat_fwd_train_raw(lib, args) -> list:
    """One raw launch of ``gat_fwd`` that writes the alpha residual, as
    the training forward does: [out, alpha]."""
    xl, xr = args[:2]
    B, S, H = xl.shape[:3]
    alpha = torch.empty((B, H, xr.shape[1], S), device="cuda")
    return [_gat_fwd_raw(lib, args, alpha), alpha]


def _gat_occupancy(symbol: str, warps, sizes=(65, 129)):
    """``occupancy`` of ``_compare`` for a GAT kernel: what ``symbol``
    (``gat_fwd_blocks_per_sm`` or ``gat_bwd_blocks_per_sm``) gives at S =
    T = n, F = 100 for each of ``sizes`` (None where a build's layout
    does not fit)."""
    import ctypes
    from ctvae_torch.ops import gat_flash as gf

    def occupancy(lib):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        res = {}
        for n in sizes:
            try:
                res[f"occupancy_{n}"] = gf._occupancy(fn, n, n, 100,
                                                      warps(n))
            except RuntimeError:
                res[f"occupancy_{n}"] = None
        return res
    return occupancy


def compare_gat_fwd(sources) -> dict:
    """The tree's ``gat_fwd`` against the ``gat_fwd`` of other ``gat.cu``
    files (``_compare``), launched raw with the alpha residual on the
    check's inputs at A*B = 192 and B = 16 and on the call of each train
    mode's step of the headline model and of the ``codebooks: 2`` model
    (S = T = 129), captured: out and alpha against the plain version's
    (``_gat_fwd_plain``), the rounds timing the serving launch (no
    alpha)."""
    import ctypes
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops.common import warps_for
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def setup(lib):
        lib.gat_fwd.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.gat_fwd.restype = ctypes.c_int
    libs = _builds("gat", gf._lib(), sources, setup)
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = {f"dense_{B}": _gat_inputs(gen, B)
              for B in (MODEL_PARAMS["action_dim"] * BATCH, BATCH)}
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        inputs.update(_step_calls(gf, "flash_gat_cuda", params, tag))

    def agree(args, got, want):
        return {"err": float((got[0] - want[0]).abs().max()),
                "alpha_err": float((got[1] - want[1]).abs().max())}

    def plain(args):
        with torch.no_grad():
            return _gat_fwd_plain(args)
    return _compare(
        "gat_fwd", libs, inputs, _gat_fwd_train_raw, agree,
        lambda a: {"xl": list(a[0].shape),
                   "edge_density": float(a[3].float().mean()),
                   "bound_ms": _gat_fwd_bound(a)[0]},
        plain=plain, timed=lambda lib, a: [_gat_fwd_raw(lib, a)],
        occupancy=_gat_occupancy("gat_fwd_blocks_per_sm", warps_for))


def _gat_bwd_raw(lib, args) -> list:
    """One raw launch of ``gat_bwd`` from ``lib`` (no wrapper, no launch
    count) on ``flash_gat_bwd_cuda``'s arguments, with the sums its wrapper
    takes: dxl, dxr, dadj [B,S,T], dwe, datt."""
    from ctvae_torch.ops import _build
    from ctvae_torch.ops.gat_flash import _bwd_warps
    xl, xr, adj, mask, we, att, alpha, dout, ns = args
    B, S, H, F = xl.shape
    T = xr.shape[1]
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    dadj_h = xl.new_empty((B, H, T, S))
    dwe_b, datt_b = xl.new_empty((B, H, F)), xl.new_empty((B, H, F))
    _build.check(lib.gat_bwd(
        *(t.data_ptr() for t in (xl, xr, adj, mask, we, att, alpha, dout,
                                 dxl, dxr, dadj_h, dwe_b, datt_b)),
        B, S, T, H, F, _bwd_warps(T), ns,
        torch.cuda.current_stream().cuda_stream), "gat_bwd")
    return [dxl, dxr, dadj_h.sum(1).transpose(1, 2), dwe_b.sum(0),
            datt_b.sum(0)]


def compare_gat_bwd(sources) -> dict:
    """The tree's ``gat_bwd`` against the ``gat_bwd`` of other ``gat.cu``
    files (``_compare``), launched raw with its wrapper's sums on the
    check's inputs at A*B = 192 and B = 16 and on the call of each train
    mode's step of the headline model and of the ``codebooks: 2`` model
    (S = T = 129), captured: the gradients against the plain version's
    from the same alpha (``_gat_plain_grads``; the worst error over each
    gradient's own scale); occupancy at 65 and 129."""
    import ctypes
    from ctvae_torch.ops import gat_flash as gf
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def setup(lib):
        lib.gat_bwd.argtypes = [p] * 13 + [i] * 6 + [f, p]
        lib.gat_bwd.restype = ctypes.c_int
    libs = _builds("gat", gf._lib(), sources, setup)
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = {}
    for B in (MODEL_PARAMS["action_dim"] * BATCH, BATCH):
        xl, xr, adj, mask, we, att, ns = _gat_inputs(gen, B)
        dout = torch.randn(B, *xr.shape[1:], generator=gen, device="cuda")
        _, alpha = gf.flash_gat_cuda(xl, xr, adj, mask, we, att, ns,
                                     keep_alpha=True)
        inputs[f"dense_{B}"] = (xl, xr, adj, mask, we, att, alpha, dout, ns)
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        inputs.update(_step_calls(gf, "flash_gat_bwd_cuda", params, tag))
    names = ("dxl", "dxr", "dadj", "dwe", "datt")
    return _compare(
        "gat_bwd", libs, inputs, _gat_bwd_raw,
        lambda a, got, want: {"err": _grad_errors(names, got, want,
                                                  own_scale=True)[1]},
        lambda a: {"xl": list(a[0].shape),
                   "edge_density": float(a[3].float().mean()),
                   "bound_ms": _gat_bwd_bound(a[0], a[1], a[3])[0]},
        plain=_gat_plain_grads,
        occupancy=_gat_occupancy("gat_bwd_blocks_per_sm", gf._bwd_warps))


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


def compare_pairwise_bwd(sources) -> dict:
    """The tree's ``pairwise_bwd`` against the ``pairwise_bwd`` of other
    ``pairwise.cu`` files (``_compare``), launched raw on the check's
    dense inputs at A*B = 192 (per sample) and B = 16 (shared) and on both
    calls of each train mode's step of the headline model and of the
    ``codebooks: 2`` model (S = T = 128), captured: the gradients against
    the plain version's autograd (the worst error over each gradient's own
    scale); the live shares of dz per input (the kernel's time depends on
    them); and at B = 16 the host's microseconds per launch call."""
    import ctypes
    from ctvae_torch.ops import pairwise_flash as pf
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def setup(lib):
        lib.pairwise_bwd.argtypes = [p] * 11 + [i] * 4 + [i64, i64,
                                                          ctypes.c_float, p]
        lib.pairwise_bwd.restype = ctypes.c_int
    libs = _builds("pairwise", pf._lib(), sources, setup)
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = {f"dense_{B}": _pairwise_bwd_inputs(gen, B, B > BATCH)[0]
              for B in (MODEL_PARAMS["action_dim"] * BATCH, BATCH)}
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        inputs.update(_step_calls(pf, "flash_pairwise_bwd_cuda", params,
                                  tag))
    names = ("dxl", "dxr", "dw2", "db1", "db2")

    def describe(args):
        live = _pairwise_live(args)
        return {**live, "bound_ms": _pairwise_bwd_bound(args,
                                                        live["pairs"])[0]}
    return _compare(
        "pairwise_bwd", libs, inputs, _pairwise_bwd_raw,
        lambda a, got, want: {"err": _grad_errors(
            names, _pairwise_folded(got, a), want, own_scale=True)[1]},
        describe, plain=_pairwise_plain_grads,
        occupancy=lambda lib: pf.bwd_occupancy(64, 64, lib))


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
    ``pairwise.cu`` files (``_compare``), launched raw on the check's
    inputs at A*B = 192 (per sample) and B = 16 (shared) and on both calls
    of each train mode's step of the headline model and of the
    ``codebooks: 2`` model (S = T = 128), captured: the output against the
    plain version's (max abs error); and at B = 16 the host's microseconds
    per launch call."""
    import ctypes
    from ctvae_torch.ops import pairwise_flash as pf
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def setup(lib):
        lib.pairwise_fwd.argtypes = [p] * 6 + [i] * 4 + [i64] * 3 + [
            ctypes.c_float, p]
        lib.pairwise_fwd.restype = ctypes.c_int
    libs = _builds("pairwise", pf._lib(), sources, setup)
    gen = torch.Generator("cuda").manual_seed(SEED)
    A = MODEL_PARAMS["action_dim"]
    inputs = {f"dense_{B}": _pairwise_fwd_inputs(gen, B, B > BATCH)
              for B in (A * BATCH, BATCH)}
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        inputs.update(_step_calls(pf, "flash_pairwise_cuda", params, tag))

    def plain(args):
        with torch.no_grad():
            return _pairwise_fwd_plain(args)
    return _compare(
        "pairwise_fwd", libs, inputs,
        lambda lib, a: [_pairwise_fwd_raw(lib, a)],
        lambda a, got, want: {"err": float((got[0] - want).abs().max())},
        lambda a: {"shape": [*a[0].shape[:2], a[1].shape[1],
                             a[0].shape[2]],
                   "per_sample": a[2].dim() == 2,
                   "bound_ms": _pairwise_fwd_bound(a)[0]},
        plain=plain,
        occupancy=lambda lib: pf.fwd_occupancy(A * BATCH, 64, 64, 800, lib))


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
    """{key: (args, d_e, ns)}: the check's inputs at A*B = 192 (K = 2) and
    at B = 16 with K = 1 and K = 2 (F = 64, per-sample heads as
    ``heads_call`` gives them), the A*B = 192 inputs with an all-zero d_e,
    and the per-head logits calls of each train mode's step of the
    headline model and of the ``codebooks: 2`` model (S = T = 129),
    captured (the backward's arguments, which are the forward's with
    d_e)."""
    from ctvae_torch.ops import gat_logits as gl
    A = MODEL_PARAMS["action_dim"]
    inputs = {}
    for B, K in ((A * BATCH, 2), (BATCH, 1), (BATCH, 2)):
        args, d_e = _logits_inputs(gen, B, K, 64, True)
        inputs[f"check_{B}_k{K}"] = (args, d_e, 0.2)
    args, d_e, ns = inputs[f"check_{A * BATCH}_k2"]
    inputs["zero_de"] = (args, torch.zeros_like(d_e), ns)
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        for key, (*args, d_e, ns) in _step_calls(
                gl, "fused_gat_logits_bwd_cuda", params, tag).items():
            inputs[key] = (tuple(args), d_e, ns)
    return inputs


def _logits_plain_grads(inputs) -> list:
    """The plain version's autograd of the logits against d_e."""
    from ctvae_torch.ops.gat import gat_logits
    args, d_e, ns = inputs
    leaves = [a.clone().requires_grad_() for a in args]
    return torch.autograd.grad(gat_logits(*leaves, ns), leaves, d_e)


def compare_gat_logits(sources) -> dict:
    """The tree's ``gat_logits_fwd`` / ``gat_logits_bwd`` against those of
    other ``gat_logits.cu`` files (``_compare``, keys ``fwd_<input>`` and
    ``bwd_<input>``), launched raw on ``_logits_compare_inputs``: the
    logits and the gradients (with the sums the backward's wrapper takes)
    against the plain version and its autograd (the worst error over
    max(1, scale), as the smoke's LOGITS_RTOL takes it); the rounds also
    time the backward kernel alone (``bwd_kernel_<input>``); registers,
    spill bytes and blocks per SM at the headline's A*B = 192 and at the
    ``codebooks: 2`` causal step's shape (where a build exports them)."""
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops.gat import gat_logits
    libs = _builds("gat_logits", gl._lib(), sources, _logits_lib)
    gen = torch.Generator("cuda").manual_seed(SEED)
    inputs = _logits_compare_inputs(gen)
    names = ("dxl", "dxr", "dadj", "dwe", "datt")

    def rel(got, want):
        return float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))

    def occupancy(lib):
        res = {}
        for key in (f"check_{MODEL_PARAMS['action_dim'] * BATCH}_k2",
                    "c2_causal_0"):
            B, S, K, F = inputs[key][0][0].shape
            T = inputs[key][0][1].shape[1]
            res[f"fwd_occupancy_{key}"] = gl.fwd_occupancy(B, S, T, K, F, lib)
            res[f"bwd_occupancy_{key}"] = gl.bwd_occupancy(B, S, T, F, lib)
        return res
    fwd = _compare(
        "gat_logits", libs,
        {k: v for k, v in inputs.items() if k != "zero_de"},
        lambda lib, a: [_logits_fwd_raw(lib, a[0], a[2])],
        lambda a, got, want: {"err": rel(got[0], want)},
        lambda a: {"shape": list(a[1].shape),
                   "bound_ms": _logits_fwd_bound(a[0])[0]},
        plain=lambda a: gat_logits(*a[0], a[2]), prefix="fwd_")
    res = _compare(
        "gat_logits", libs, inputs,
        lambda lib, a: list(_logits_bwd_raw(lib, *a)),
        lambda a, got, want: {"err": _grad_errors(names, got, want)[1]},
        lambda a: {"shape": list(a[1].shape),
                   "live_share": int((a[1] != 0).sum()) / a[1].numel(),
                   "bound_ms": _logits_bwd_bound(a[0], a[1])[0]},
        plain=_logits_plain_grads, occupancy=occupancy, prefix="bwd_")
    for key, a in inputs.items():
        _paired_times(res["builds"], libs, f"bwd_kernel_{key}",
                      lambda lib: _logits_bwd_raw(lib, *a, fold=False))
    for name, r in res["builds"].items():
        r.update(fwd["builds"][name])
    res["inputs"].update(fwd["inputs"])
    return res


def _vq_raw(lib, x, cb) -> torch.Tensor:
    """One raw launch of ``vq_argmin`` from ``lib`` (no wrapper, no launch
    count)."""
    from ctvae_torch.ops import _build
    out = torch.empty((x.shape[0],), dtype=torch.int64, device="cuda")
    _build.check(lib.vq_argmin(x.data_ptr(), cb.data_ptr(), out.data_ptr(),
                               x.shape[0], cb.shape[0], x.shape[1],
                               torch.cuda.current_stream().cuda_stream),
                 "vq_argmin")
    return out


def compare_vq(sources) -> dict:
    """The tree's ``vq_argmin`` against the ``vq_argmin`` of other ``vq.cu``
    files (``_compare``), launched raw on the check's inputs at N = 1024,
    K = 64 and each D of VQ_DIMS, and on the calls of each train mode's
    step of the headline model (D = 128) and of the ``codebooks: 2`` model
    (D = 64), captured: the indices against the plain version's (those
    that differ, of them near-ties); occupancy at each D of VQ_DIMS."""
    import ctypes
    from ctvae_torch.ops import vq
    p, i = ctypes.c_void_p, ctypes.c_int

    def setup(lib):
        lib.vq_argmin.argtypes = [p, p, p, i, i, i, p]
        lib.vq_argmin.restype = ctypes.c_int
    libs = _builds("vq", vq._lib(), sources, setup)
    gen = torch.Generator("cuda").manual_seed(SEED)
    N, K = BATCH * 64, MODEL_PARAMS["num_embeddings"]
    inputs = {}
    for D in VQ_DIMS:
        inputs[f"check_d{D}"] = (
            torch.randn(N, D, generator=gen, device="cuda") * 0.3,
            (torch.rand(K, D, generator=gen, device="cuda") * 2 - 1) / K)
    for tag, params in (("", MODEL_PARAMS), ("c2_", C2_MODEL_PARAMS)):
        inputs.update(_step_calls(vq, "l2_argmin_cuda", params, tag))

    def agree(args, got, want):
        differ, near_ties, _ = _vq_agreement(*args, got[0])
        return {"differ": differ, "near_ties": near_ties}
    return _compare(
        "vq", libs, inputs, lambda lib, a: [_vq_raw(lib, *a)], agree,
        lambda a: {"x": list(a[0].shape), "codebook": list(a[1].shape),
                   "bound_ms": _vq_bound(*a)[0]},
        occupancy=lambda lib: {f"occupancy_d{D}": vq.occupancy(K, D, lib)
                               for D in VQ_DIMS})


def _other_package(tree: str, name: str):
    """The ``ctvae_torch`` package of another checkout ``tree`` (an
    earlier commit's), imported as ``name`` beside this tree's; its
    kernels build into its own ``_build``."""
    import importlib.util
    root = os.path.join(os.path.abspath(tree), "ctvae_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


STEP_ROUNDS = 21    # timed rounds of the train step comparison
STEP_CALLS = 8      # steps per build per round


def compare_train_step(trees) -> dict:
    """This tree's eager train step against the ``make_train_step`` of
    other checkouts' ``ctvae_torch``, per mode at the headline widths and
    B = 16 with the config's exp_params, each build from the same weights
    on the same batch: after a warm-up step (its loss logged for each
    build), STEP_ROUNDS rounds of STEP_CALLS steps per build, the builds
    in turns (the order reversed every other round), each timed from the
    host clock to the device's end; the median ms per step. Then one
    profiled step per build (``_profile``): its launches and device ms."""
    import importlib
    packages = {"tree": "ctvae_torch"}
    for i, tree in enumerate(trees):
        packages[tree] = _other_package(tree, f"other{i}_ctvae_torch").__name__
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 3), BATCH,
                        "cuda")
    batch = {"image": x, "input_y": y, "action": a}
    out = {}
    for mode in EXPECTED_TRAIN:
        runs, first = {}, {}
        for name, package in packages.items():
            models = importlib.import_module(f"{package}.models")
            training = importlib.import_module(f"{package}.training")
            model = models.build_model(
                MODEL_PARAMS, device="cuda",
                generator=torch.Generator("cuda").manual_seed(SEED))
            opts = training.build_optimizers(EXP_PARAMS, model,
                                             steps_per_epoch=100)
            state = training.create_train_state(model, opts, seed=SEED)
            step = training.make_train_step(mode)
            first[name] = float(step(state, batch)["loss"])
            runs[name] = (lambda step=step, state=state: step(state, batch))
        samples = {name: [] for name in runs}
        for r in range(STEP_ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(STEP_CALLS):
                    runs[name]()
                torch.cuda.synchronize()
                samples[name].append(
                    1e3 * (time.perf_counter() - t0) / STEP_CALLS)
        out[mode] = {name: {"ms": statistics.median(t),
                            "samples": [round(v, 3) for v in t],
                            "first_loss": first[name]}
                     for name, t in samples.items()}
        for name, run in runs.items():
            rows = _profile(f"train step {mode} B={BATCH} {name}", run)
            out[mode][name].update(launches=sum(r[2] for r in rows),
                                   device_ms=sum(r[1] for r in rows))
        log(f"train step {mode} B={BATCH}: " + "; ".join(
            f"{name} {m['ms']:.3f} ms per step (rounds {m['samples']}, first "
            f"loss {m['first_loss']:.7g})" for name, m in out[mode].items()))
        del runs
        torch.cuda.empty_cache()
    return out


# keys of a check's row that the kernels line carries beside the contract's
EXTRA_KEYS = ("ms_at_16", "bound_ms_at_16", "plain_ms_at_16", "alpha_ms",
              "occupancy", "by_d")

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
        "--gat-bwd-against", nargs="+", metavar="GAT_CU",
        help="only build the kernels and compare the tree's gat_bwd with "
             "the gat_bwd of these gat.cu files (compare_gat_bwd)")
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
        "--vq-against", nargs="+", metavar="VQ_CU",
        help="only build the kernels and compare the tree's vq_argmin with "
             "the vq_argmin of these vq.cu files (compare_vq)")
    parser.add_argument(
        "--gat-logits-against", nargs="+", metavar="GAT_LOGITS_CU",
        help="only build the kernels and compare the tree's gat_logits_fwd "
             "and gat_logits_bwd with those of these gat_logits.cu files "
             "(compare_gat_logits)")
    parser.add_argument(
        "--metrics-only", action="store_true",
        help="only build the kernels and run the phase \"metrics\" "
             "(phase_metrics)")
    parser.add_argument(
        "--train-step-against", nargs="+", metavar="TREE",
        help="only build the kernels and time the tree's eager train step "
             "in turns with those of these checkouts (compare_train_step)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on a card",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    smi = phase_card()
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
    if opts.gat_bwd_against:
        log(json.dumps({"gat_bwd_against": compare_gat_bwd(
            opts.gat_bwd_against)}))
        return 0
    if opts.vq_against:
        log(json.dumps({"vq_against": compare_vq(opts.vq_against)}))
        return 0
    if opts.metrics_only:
        launches, seconds = phase_metrics(smi)
        log(json.dumps({"metrics_launches": launches,
                        "metric_seconds": seconds}))
        return 0
    if opts.train_step_against:
        log(json.dumps({"train_step_against": compare_train_step(
            opts.train_step_against)}))
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
    c2_ms, c2_launches, c2_on_step = phase_codebooks_2()
    phase_loop()
    two_stage_launches = phase_two_stage()
    scan_launches, scan_ms = phase_scan()
    phase_bench()
    mcq_launches, ct_launches, s3d_on_step = phase_shapes3d()
    metric_launches, metric_seconds = phase_metrics(smi)
    kernels = []
    for r in rows:
        source, replaces = KERNEL_META[r["name"]]
        by_path = {"serve": serve_launches[r["name"]],
                   "train": train_launches[r["name"]],
                   "codebooks_2": c2_launches[r["name"]],
                   "two_stage": two_stage_launches[r["name"]],
                   "scan": scan_launches[r["name"]],
                   "shapes3d_mcq": mcq_launches[r["name"]],
                   "shapes3d_ct": ct_launches[r["name"]],
                   "metrics": metric_launches[r["name"]]}
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
        kernels[-1].update(c2_on_step.get(r["name"], {}))
        kernels[-1].update(s3d_on_step.get(r["name"], {}))
    # every kernel runs on the training, codebooks: 2, two-stage, scan,
    # shapes3d CT and metrics paths, the forward ones on the serving path
    # too, the VQ search on the MCQVAE's (which has no CT layer)
    if any(k["launches_by_path"][p] == 0 for k in kernels
           for p in ("train", "codebooks_2", "two_stage", "scan",
                     "shapes3d_ct", "metrics")) or any(
            k["launches_by_path"]["serve"] == 0 for k in kernels
            if EXPECTED["reconstruct"][k["name"]]) or any(
            (k["launches_by_path"]["shapes3d_mcq"] == 0)
            != (k["name"] != "vq_l2_argmin") for k in kernels):
        raise AssertionError("a kernel of a path was never launched")
    log(json.dumps({"serve_ms": timings, "train_ms": train_ms,
                    "train_peak_gib": peak, "codebooks_2_train_ms": c2_ms,
                    "scan_ms": scan_ms, "metric_seconds": metric_seconds}))
    log(f"chip_smoke wall time {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
