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
same widths (phase "loop"). Then more phases:

* scan: per train mode, 16 steps at the headline widths and B = 16
  taken eagerly from one state and through ``make_multi_train_step(mode,
  8)`` (warm-up steps, then replays of a captured CUDA graph) from an
  equal state on the same batches: every parameter and Adam moment
  within 1e-6 of its largest magnitude, the generators and steps equal;
  then both timed in turns. The graph's kernel launches are counted at
  capture, times its replays (the ``scan`` path of the kernels line).
  The same with ``accumulate_grad_batches: 3`` (two graphs, accumulate
  and apply, chosen per step), and a state saved after the first call,
  in the middle of an accumulation, loaded and continued by a new
  multi-step call (the ``scan_accum`` path);
* bench: ``python -m ctvae_torch.bench --blocks 1`` at its default
  config, its last line checked for every key and an ``mfu`` in (0, 1]
  per mode, and printed.
* shapes3d: ``configs/mcq_vae.yaml`` and ``configs/ct_mcq_vae.yaml`` as
  ``config.read_config`` reads them, trained one epoch each through
  ``run.train`` on a Shapes3D stand-in (30,720 images, all six factors)
  that the port writes to a temporary directory (whose train split's
  transform cache is first written beside it and mapped again), with
  their checkpoints,
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
* search: the paper's hyperparameter search,
  ``configs_hyp/ct_mcq_vae_hyp_search_shapes3d.yaml`` at its widths and
  B = 8. (a) One model per corner of its space (noise off / endo x
  codebooks 1 / 2 x 16 / 32 codes), a warm and a timed train step per
  mode, then every kernel call of each mode's step held against its plain
  version on its own inputs and timed there with its plain version and
  bound (66 / 130 GAT nodes under endo; the logits kernels at F = 16 /
  32; the VQ search at 16 / 32 codes, with ``cdist`` + ``argmin``). (b)
  An EMA model (revival, the rotation estimator, endo) trained 16 steps
  eagerly, again eagerly, and through ``make_multi_train_step(mode, 8)``
  from equal states: every parameter, Adam moment and EMA buffer within
  1e-6 of its largest magnitude (cuDNN deterministic). (c) The search
  CLI's ``main`` with ``scheduler: asha`` on 4 trials of a TShapes3D
  stand-in, every trial finite. The launches of (a)'s timed steps and of
  (c) make the path ``search``.

* celeba: the port's JPEG codec built (``ctvae_torch/native``: nvJPEG
  on a machine without libjpeg) and a CelebA stand-in of 8,000 JPEGs of
  178 x 218 written in a temporary directory (quality 80; the smoke's own
  80 / 10 / 10 split and attribute file; ``variation_attrs_10.txt``),
  then (c) the decode of a batch of 64 against the arrays it was
  rendered from and of the committed libjpeg reference
  (``tests/torch_jpeg_reference.npz``) against libjpeg's pixels, the
  decode's and the transform's host ms, the transform's products on the
  card against the CPU, ``read_png`` of a photo-sized Paeth-filtered PNG
  (exact, and its host ms); (d) ``run.train`` of ``configs/vae.yaml``,
  ``vq_vae.yaml`` and ``cvae.yaml`` with ``dataset_name: Celeba`` as
  written (one epoch each), the loader's host ms and its share of each
  epoch (steps in turns with batches held and inline), VQVAE's VQ
  search calls at K = 512 (path ``celeba_vq``); (e)
  ``configs/ct_mcq_vae.yaml`` at full width on TCeleba with
  ``action_dim: 20`` (21 GAT heads, causal A*B = 320), one epoch cut by
  ``limit`` (path ``tceleba``), every kernel call of each mode's step
  held against its plain version and timed with it and its bound; (f)
  ConditionalVAE's ``reconstruct`` / ``encode`` / ``sample`` with labels
  against the CPU (1e-5). The VanillaVAE and ConditionalVAE runs make the
  path ``celeba`` (no kernel).
* gaussian: VQVAE and the Gaussian zoo from their YAML at full width on
  the same CelebA stand-in (``dataset_name: Celeba`` as written, only
  ``data_path`` changed; phase "celeba" trains ``configs/vae.yaml`` and
  ``configs/vq_vae.yaml`` there): ``run.train`` of ``configs/lvae.yaml``,
  ``configs/gammavae.yaml`` and ``configs/cat_vae.yaml`` (B = 64, one
  epoch, checkpoints and grids) and of ``configs/synthetic_vae.yaml``;
  every VQ search call of a VQVAE train step and of its eval step (K =
  512 codes of 64, N = 16,384 rows) held against the plain version and
  timed with it and ``cdist`` + ``argmin``;
  a warm and timed eager train steps of VanillaVAE, VQVAE, of bbvae,
  bhvae, logcosh_vae, dip_vae, infovae, wae_mmd_imq and wae_mmd_rbf, and
  of iwae, miwae, swae, betatc_vae, cat_vae, joint_vae, gammavae,
  vampvae, hvae and lvae at B = 64 (ms, the profiled step's device-busy
  share, peak memory); the ``reconstruct`` / ``encode`` / ``sample`` of
  VanillaVAE and of those ten at B = 16 against the CPU on the same
  draws; ``make_multi_train_step("base", 8)`` against eager steps for
  VanillaVAE, BetaVAE B, CategoricalVAE (the step drives its
  temperature) and GammaVAE (a gamma draw under capture), cuDNN
  deterministic. Then the last of the registry (``_zoo_last``):
  ``configs/dfc_vae.yaml`` as written must refuse to train without VGG
  weights; with ``allow_random_features``, mssim_vae, dfc_vae and
  factorvae each a first full-width step against the CPU (FactorVAE's two
  optimizer calls), timed steps and serving; ``run.train`` of dfc_vae and
  factorvae one epoch of 50 steps with the loader's share; the MSSIMVAE
  and DFCVAE graphs against eager steps; TwoStageVAE at vae.yaml's widths,
  a stage-1 and a stage-2 step against the CPU and its serving. VQVAE's
  steps make the path ``gaussian_vq`` (the VQ search only), the rest the
  path ``gaussian`` (no kernel).
* export: the serving artifacts of ``ctvae_torch/serving/export.py``:
  ``configs/ct_mcq_vae.yaml``'s five entry points exported on the card
  with a symbolic batch at B = 16 (``export_model``'s functions; the
  seconds of each export), ``vq_vae.yaml``'s and ``vae.yaml``'s at B =
  64; each artifact loaded by a subprocess that imports no model code and
  served at two batch sizes against the live port on the same keys, and
  through the same files moved to the CPU at B = 2 against the card; the
  artifact's and the live port's request ms in turns. The artifacts'
  requests make the path ``export`` (the four forward kernels).

* sp: sequence parallelism, after "ddp": the headline at full width with
  ``seq_axis="model"`` on two gloo ranks sharing the card at (data 1,
  model 2), each rank's kernels on its block of targets (pairwise 32 of
  64 columns, GAT 33 / 32 of 65 nodes): 8 steps a mode against one
  process from equal states (losses and gradients to tier-1's bound),
  every split launch's block checked, each kernel call of a causal step
  held against its plain version at the block shapes, the serving entry
  points under ``model_parallel`` against one process, 3 causal steps at
  bfloat16; each rank's peak bytes against one process's, the
  collectives' bytes and step ms (a correctness path: report, judge
  nothing). These launches make the path ``sp`` (``phase_sp``;
  ``--sp-only`` runs it alone). Then, inside the phase, the path
  ``fsdp_tp``: ``sharding: fsdp`` with a model axis of 2 (JAX's
  tensor-parallel rules split the discoverer's hidden axis and the
  codebook's entries over the two ranks) on two gloo ranks sharing the
  card: 8 steps a mode against one process from equal states, each
  rank's resident bytes of blocks and Adam moments against one
  process's, every kernel call of a causal step on the gathered
  parameters held against its plain version, ``run.train`` at world 2
  with ``scan_steps: 4`` (an eager loop over gloo: ``graphed`` false)
  against one process (graph replays), 3 causal steps at bfloat16
  (``_fsdp_tp_path``; ``--fsdp-tp-only`` runs it alone).
* bf16: the headline config at ``dtype: bfloat16`` (the JAX bench's
  dtype): requests of the four entry points, 16 eager steps a mode and
  two ``make_multi_train_step(mode, 8)`` calls from an equal state (every
  parameter and Adam moment bit-equal), and ``configs/mcq_vae.yaml`` /
  ``vae.yaml``, the 21 other zoo YAMLs and TwoStageVAE's two stages a
  few steps each at bfloat16 make the path ``bf16`` (each of the last
  23 also a first step at B = 2 against the CPU and float32 against
  bfloat16 ms per step in turns, after the path); every
  kernel call of a base, an action and a causal step held against its
  plain version at bfloat16 (the bfloat16 instantiations of rows 2-6, and
  the float32 VQ search on the upcast latents) and timed with its bound
  (bytes at each tensor's element size); the four entry points and a
  first step per mode at B = 2 against the CPU port; float32 against
  bfloat16 step and request ms in turns (``phase_bf16``;
  ``--bf16-only`` runs it alone).

    python3 chip_smoke.py --search-only

builds the kernels and runs only the phase "search" (``phase_search``);
``--gaussian-only`` only the phase "gaussian" (``phase_gaussian``) and
``--celeba-only`` only the phase "celeba" (``phase_celeba``), each after
writing the CelebA stand-in; ``--export-only`` only the phase "export"
(``phase_export``).

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
Every run prints, before its last lines, one line ``{"wall_s": {...}}``:
the wall seconds of each phase, path and part (``<phase>.<part>``) it
ran, and the total (on stderr after a failure).

    python3 chip_smoke.py --train-step-against OTHER_CHECKOUT [...]

times the tree's eager train step of each mode in turns with that of
other checkouts' ``ctvae_torch`` (an earlier commit's), at the headline
widths and B = 16 (``compare_train_step``).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings

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


#: wall seconds of each phase and path run so far, in the order they ran;
#: a part of a phase is named ``<phase>.<part>`` and counts in the phase's
#: seconds too
WALL: dict = {}


@contextlib.contextmanager
def wall(name: str):
    """Adds the wall seconds of the block to WALL[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        WALL[name] = round(WALL.get(name, 0.0)
                           + time.perf_counter() - t0, 1)


def walled(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept in WALL[name]."""
    with wall(name):
        return fn(*args, **kwargs)


def log_walls(start: float) -> None:
    """The line of wall seconds: every phase and path run, and the total."""
    log(json.dumps({"wall_s": {**WALL, "total": round(
        time.perf_counter() - start, 1)}}))


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
    db2 folded into their param's shape (db2, which cancels, the float64
    sum of the float32 dz, rounded once, as the op forms it). Taken
    ``chunk`` samples at a time (pre of the causal step at S = T = 128
    takes 10 GB whole): per-sample gradients concatenate, a shared
    param's sum over the chunks."""
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
        parts.append(grads + [dz.double().sum((1, 2)) if w2.dim() == 2
                              else dz.double().sum()])
    per_sample = (True, True, w2.dim() == 2, b1.dim() == 2, w2.dim() == 2)
    grads = [torch.cat([p[i] for p in parts]) if per_sample[i]
             else sum(p[i] for p in parts) for i in range(5)]
    return grads[:4] + [grads[4].float()]


def _db2_sums(args, got, want) -> dict:
    """db2 is the sum of dz = dout out (1 - out) over a sample's pairs (all
    samples' for a shared b2), which cancels: the largest sum of |dz|, the
    float64 sum of the same float32 dz, their ratio, and the kernel's and
    the plain version's (a float32 sum) distances from that float64 sum,
    each over its scale, beside float32's rounding of a sum of those
    terms: 2^-24 x sum |dz| over the scale per addition."""
    out, dout = args[4].detach(), args[5].detach()
    dz = dout * out * (1 - out)
    dims = (1, 2) if args[2].dim() == 2 else (0, 1, 2)
    s64, a64 = dz.double().sum(dims), dz.abs().double().sum(dims)
    scale, total = float(s64.abs().max()), float(a64.max())

    def rel(x):
        err = float((x.double() - s64).abs().max())
        return err / scale if scale else (0.0 if err == 0 else None)
    return {"sum_abs_dz": total, "sum64_scale": scale,
            "cancel": total / scale if scale else None,
            "eps_sum_abs": 2.0 ** -24 * total / scale if scale else None,
            "kernel_err64": rel(got), "plain_err64": rel(want)}


def _pairwise_folded(grads, args) -> list:
    """The kernel's per-sample dw2, db1, db2 folded as its caller folds
    them (summed over the batch for a shared param)."""
    from ctvae_torch.ops.library import _fold
    w2 = args[2]
    return [grads[0], grads[1], _fold(grads[2], w2), _fold(grads[3], w2),
            grads[4] if w2.dim() == 2 else grads[4].double().sum().float()]


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
    """The backward kernel (``flash_gat`` under autograd: the gradient of
    ``ctvae::gat_fwd_alpha``) against the plain
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
            m["db2"] = _db2_sums(args, got[4], want[4])
            _, m["control_err"], m["control_errors"] = _grad_errors(
                names, _pairwise_plain_grads(args[:6] + (1.0,)), want,
                own_scale=True)
            if not m["err"] <= GRAD_RTOL:
                raise AssertionError(f"pairwise_bwd on the step's inputs: "
                                     f"{m['errors']}; db2's sums "
                                     f"{json.dumps(m['db2'])}")
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
    # dxl, dxr, dadj and the stacked dwe / datt, unstacked
    *got, dw = gl.fused_gat_logits_bwd_cuda(*args, d_e, ns)
    got += dw.unbind(-3)
    *again, dw = gl.fused_gat_logits_bwd_cuda(*args, d_e, ns)
    again += dw.unbind(-3)
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

        def normal(self, shape):
            return torch.randn(tuple(shape), generator=self.generator
                               ).to(self.device)

        def randint(self, low, high, shape):
            return torch.randint(low, high, tuple(shape),
                                 generator=self.generator).to(self.device)

        def gamma(self, alpha):
            return torch._standard_gamma(alpha.detach().cpu(),
                                         generator=self.generator
                                         ).to(self.device)

        def cauchy(self, shape):
            return torch.empty(tuple(shape)).cauchy_(
                generator=self.generator).to(self.device)

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


def _profile(label: str, fn, gemm_shapes: bool = False,
             stats: dict = None) -> list:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the share of its wall time the card was busy (the profiler's ranges,
    such as ``Adam.step``'s, are logged apart: their time is that of
    kernels already counted); with ``gemm_shapes``
    then, over a second call profiled with ``record_shapes`` (whose host
    cost stays out of the busy share), the dense products by input shape:
    each ``GEMM_OPS`` op with the device time of the kernels it launched.
    Returns (kernel, ms, count) rows of the first call, longest first;
    ``stats``, when given, gets the first call's ``wall_ms`` and
    ``busy_ms``."""
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
    if stats is not None:
        stats.update(wall_ms=wall, busy_ms=busy)
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

def _train_setup(params=MODEL_PARAMS, B: int = BATCH, exp=EXP_PARAMS):
    """The headline model (or ``params``) at batch ``B`` (16) with the
    config's exp_params (or ``exp``): (model, train state, batch, a train
    step per mode)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    model = build_model(params, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(
        model, build_optimizers(exp, model, steps_per_epoch=100),
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
        log(f"{label} {mode} B={batch['image'].shape[0]}: "
            f"{timings[mode]:.3f} ms per step "
            f"(median of {len(timed)} after a warm-up of "
            f"{1e3 * secs[0]:.3f}; min {min(timed):.3f}, max "
            f"{max(timed):.3f}); last loss {loss:.6g}, grad_norm "
            f"{float(metrics['grad_norm']):.6g}")
    return timings


def phase_train():
    """Train steps of each mode at the headline width, B = 16, with the
    config's exp_params; the launch counters are reset just before and
    read just after. Then one profiled step per mode, and the plain
    versions timed on each mode's own kernel inputs
    (``_plain_ms_on_step``)."""
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
    # the plain versions' ms on each mode's own inputs, beside the kernels'
    plain = {mode: _plain_ms_on_step(lambda: step(state, batch))
             for mode, step in steps.items()}
    for mode, ms in plain.items():
        log(f"train {mode}: the plain versions on the step's own inputs, "
            f"ms {json.dumps(ms)}")
    for name in plain["causal"]:
        on_step[name]["plain_ms_on_steps"] = {m: p[name]
                                              for m, p in plain.items()}
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
            f"{m['control_errors']}; db2's sums {json.dumps(m['db2'])}")
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
    version on their own inputs (``_kernels_on_step``), and the plain
    versions timed there (``_plain_ms_on_step``); and one profiled causal
    step."""
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
    # the plain versions' ms on each mode's own inputs, beside the kernels'
    for mode, step in steps.items():
        plain = _plain_ms_on_step(lambda: step(state, batch))
        f = found[mode]
        for k in ("pairwise_fwd", "pairwise_bwd"):
            for which, ms in plain[k].items():
                f[k][which]["plain_ms"] = ms
        for k in ("gat_fwd", "gat_bwd"):
            f[k]["plain_ms"] = plain[k]
        for which in ("fwd", "bwd"):
            f["logits"][which]["plain_ms"] = plain[f"gat_logits_{which}"]
        log(f"codebooks_2 {mode}: the plain versions on the step's own "
            f"inputs, ms {json.dumps(plain)}")
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
SCAN_ROUNDS = 3     # timed rounds of K eager steps and one K-step call
SCAN_ACCUM = 3      # accumulate_grad_batches of the path scan_accum


def _scan_tensors(state) -> dict:
    """Every parameter, buffer (an EMA codebook's), Adam moment and
    accumulated gradient mean of a train state, by name."""
    out = {n: p.detach() for n, p in state.model.named_parameters()}
    out.update(state.model.named_buffers())
    names = {id(p): n for n, p in state.model.named_parameters()}
    for opt in state.optimizers:
        for p in opt.params:
            for k, v in opt.adam.state.get(p, {}).items():
                out[f"{names[id(p)]}:{k}"] = v
        if opt.accumulate > 1:
            for p, a in zip(opt.params, opt.acc_buffers()):
                out[f"{names[id(p)]}:acc"] = a
    return out


def _scan_agree(label: str, eager, graph, want, got, replays: int) -> None:
    """Every tensor of ``_scan_tensors`` of the two states within
    SCAN_RTOL of its largest magnitude; the generator states, steps and
    the optimizers' ``count`` and ``mini_step`` exactly. Raises where
    they are not."""
    from ctvae_torch.training.state import WARMUP_STEPS
    a, b = _scan_tensors(eager), _scan_tensors(graph)
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: tensors {set(a) ^ set(b)}")
    diffs = {n: float((a[n].float() - b[n].float()).abs().max())
             for n in a}
    bad = {n: d for n, d in diffs.items() if d > SCAN_RTOL * max(
        float(a[n].float().abs().max()), 1e-30)}
    same_gen = torch.equal(eager.generator.get_state(),
                           graph.generator.get_state())
    counts = ([(o.count, o.mini_step) for o in eager.optimizers],
              [(o.count, o.mini_step) for o in graph.optimizers])
    log(f"{label}: {len(diffs)} parameters, Adam moments and means after "
        f"{eager.step} steps, eager vs {replays} graph replays "
        f"(after {WARMUP_STEPS} warm-up steps): "
        f"{sum(d == 0 for d in diffs.values())} bit-equal, largest abs "
        f"difference {max(diffs.values()):.3g}; generator equal "
        f"{same_gen}, step {eager.step} / {graph.step}, optimizer "
        f"(count, mini_step) {counts[0]} / {counts[1]}; last loss "
        f"{float(want['loss']):.6g} / {float(got['loss']):.6g}")
    if bad or not same_gen or eager.step != graph.step or \
            counts[0] != counts[1]:
        log(f"{label}: max abs difference by tensor "
            f"{json.dumps({n: float(f'{d:.3g}') for n, d in diffs.items()})}")
        raise AssertionError(f"{label}: graph and eager steps disagree: "
                             f"{bad}, generator {same_gen}, counts {counts}")


def _scan_per_replay(label: str, multi, expected) -> None:
    """Each captured graph of ``multi`` holds ``expected`` launches."""
    for graphs in multi._graphs.values():
        for phase, g in graphs.items():
            if g.launches != expected:
                raise AssertionError(f"{label}: launches per {phase} "
                                     f"replay {g.launches}, expected "
                                     f"{expected}")


def _scan_timed(label: str, step, eager, multi, graph, batches) -> dict:
    """SCAN_ROUNDS rounds, in turns, of K eager steps and one K-step call,
    timed from the host clock to the device's end: median ms per step."""
    secs = {"eager": [], "graph": []}

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
    ms = {w: statistics.median(t) for w, t in secs.items()}
    log(f"{label} B={BATCH}: eager {ms['eager']:.3f} ms per step, graph "
        f"replay {ms['graph']:.3f} ms per step (medians of {SCAN_ROUNDS} "
        f"rounds of {SCAN_K} steps in turns; eager "
        f"{json.dumps([round(t, 3) for t in secs['eager']])}, graph "
        f"{json.dumps([round(t, 3) for t in secs['graph']])})")
    return ms


def _scan_accum(mode: str, expected, stacked, launches: dict) -> dict:
    """The path scan_accum of one mode: the config's exp_params with
    ``accumulate_grad_batches`` SCAN_ACCUM, 2K eager steps from one state
    against two ``make_multi_train_step(mode, K)`` calls from an equal
    state (the phases of the accumulation wrap across the calls: K is no
    multiple of SCAN_ACCUM), and against a third state loaded from the
    second's ``state_dict`` after its first call, in the middle of an
    accumulation, and continued by a new multi-step call. Each graph
    (accumulate and apply) holds ``expected`` launches. Adds the replays'
    launches to ``launches``; returns the ms per step."""
    from ctvae_torch.training import make_multi_train_step
    from ctvae_torch.training.state import WARMUP_STEPS
    exp = {**EXP_PARAMS, "accumulate_grad_batches": SCAN_ACCUM}
    _, eager, _, steps = _train_setup(exp=exp)
    _, graph, _, _ = _train_setup(exp=exp)
    _, resumed, _, _ = _train_setup(exp=exp)
    step, multi = steps[mode], make_multi_train_step(mode, SCAN_K)
    halves = [{k: v[h] for k, v in stacked.items()}
              for h in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K))]
    for i in range(2 * SCAN_K):
        want = step(eager, {k: v[i] for k, v in stacked.items()})
    multi(graph, halves[0])
    saved = copy.deepcopy(graph.state_dict())
    got = multi(graph, halves[1])
    resumed.load_state_dict(saved)
    again = make_multi_train_step(mode, SCAN_K)
    more = again(resumed, halves[1])
    torch.cuda.synchronize()
    opt = saved["optimizers"][0]
    if multi.replays != 2 * SCAN_K - WARMUP_STEPS or not multi.graphed or \
            again.replays != SCAN_K - WARMUP_STEPS or not again.graphed \
            or opt["mini_step"] != SCAN_K % SCAN_ACCUM \
            or opt["acc"] is None:
        raise AssertionError(f"scan_accum {mode}: replays {multi.replays} "
                             f"and {again.replays}, saved mini_step "
                             f"{opt['mini_step']}")
    _scan_agree(f"scan_accum {mode}", eager, graph, want, got,
                multi.replays)
    _scan_agree(f"scan_accum {mode} loaded at mini_step "
                f"{opt['mini_step']}", eager, resumed, want, more,
                again.replays)
    for m in (multi, again):
        _scan_per_replay(f"scan_accum {mode}", m, expected)
        for k, n in m.replayed_launches().items():
            launches[k] += n
    return _scan_timed(f"scan_accum {mode} (accumulate_grad_batches "
                       f"{SCAN_ACCUM})", step, eager, multi, graph,
                       halves[0])


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
    The same again with ``accumulate_grad_batches`` (the path scan_accum,
    ``_scan_accum``). Returns (the kernels' launches by the replays of
    the paths scan and scan_accum, ms per step of each)."""
    from ctvae_torch.training import make_multi_train_step
    from ctvae_torch.training.state import WARMUP_STEPS
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    accum_launches, timings = dict(launches), {}
    gen = torch.Generator().manual_seed(SEED + 5)
    for mode, expected in EXPECTED_TRAIN.items():
        _, eager, _, steps = _train_setup()
        _, graph, _, _ = _train_setup()
        xs = [_requests(gen, BATCH, "cuda") for _ in range(2 * SCAN_K)]
        stacked = {k: torch.stack([r[i] for r in xs])
                   for i, k in enumerate(("image", "input_y", "action"))}
        step, multi = steps[mode], make_multi_train_step(mode, SCAN_K)
        with wall("scan.scan"):
            for i in range(2 * SCAN_K):
                want = step(eager, {k: v[i] for k, v in stacked.items()})
            for half in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K)):
                got = multi(graph, {k: v[half] for k, v in stacked.items()})
            torch.cuda.synchronize()
            if multi.replays != 2 * SCAN_K - WARMUP_STEPS:
                raise AssertionError(f"scan {mode}: {multi.replays} replays")
            _scan_agree(f"scan {mode}", eager, graph, want, got,
                        multi.replays)
            _scan_per_replay(f"scan {mode}", multi, expected)
            for k, n in multi.replayed_launches().items():
                launches[k] += n
            timings[mode] = _scan_timed(
                f"scan {mode}", step, eager, multi, graph,
                {k: v[:SCAN_K] for k, v in stacked.items()})
        del eager, graph, multi
        with wall("scan.scan_accum"):
            timings[f"{mode} accumulate"] = _scan_accum(
                mode, expected, stacked, accum_launches)
    log(f"launches of the scan path (captured x replays): "
        f"{json.dumps(launches)}")
    log(f"launches of the scan_accum path (captured x replays): "
        f"{json.dumps(accum_launches)}")
    return launches, accum_launches, timings


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
    ``python -m ctvae_torch.bench --blocks 1`` at its default config
    (``configs/ct_mcq_vae.yaml``): its output, then its last line checked
    (at most 1,500 characters, every key, every ``mfu`` in (0, 1])."""
    t0 = time.perf_counter()
    _check_bench_batch()
    log(f"bench batch: every kernel call of a base and an action step held "
        f"against the plain version in {time.perf_counter() - t0:.1f} s")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ctvae_torch.bench",
                           "--blocks", "1"], cwd=root, capture_output=True,
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
SHAPES3D_EPOCH_BATCHES = 24   # steps of each turn of the epoch
#: the turns of the Shapes3D epochs, in an order that balances warm-up
SHAPES3D_TURNS = ("held", "thread", "inline", "inline", "thread", "held")


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


def _check_run(label: str, cfg: dict, out: dict, logs: str,
               samples: bool = True, watch=None,
               diverge_from: int = None) -> str:
    """A run's metrics finite, unless the run was watched (``watch``, a
    _NonfiniteWatch: its first non-finite step was non-finite on the CPU
    too from the same state) and turned non-finite no earlier than
    ``diverge_from`` (DIVERGE_IN_EPOCHS); and in its ``version_0``: the
    checkpoints, ``scalars.jsonl`` lines, valid image grids (a Samples
    grid exactly when ``samples``: a model without a prior writes none).
    Returns the run's dir."""
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    first = None if watch is None else watch.first
    if bad and diverge_from is not None and first is not None \
            and first >= diverge_from:
        log(f"{label}: non-finite metrics {bad} from step {first}, as on "
            f"the CPU from the same state (its reference diverges from "
            f"step {diverge_from})")
        bad = {}
    run_dir = os.path.join(logs, cfg["logging_params"]["name"], "version_0")
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    name = cfg["model_params"]["name"]
    grids = (("Inputs", "real_img_"), ("Reconstructions", "recons_")) + (
        (("Samples", ""),) if samples else ())
    pngs = [os.path.join(run_dir, sub, f"{prefix}{name}_Epoch_0.png")
            for sub, prefix in grids]
    invalid = [p for p in pngs if not _valid_png(p)]
    extra = [] if samples else os.listdir(os.path.join(run_dir, "Samples"))
    if bad or "last" not in ckpts or not any(
            c.startswith("step_") for c in ckpts) or not scalars or invalid \
            or extra:
        raise AssertionError(f"{label}: non-finite {bad} (first "
                             f"non-finite step {first}), checkpoints "
                             f"{ckpts}, {len(scalars)} scalar lines, "
                             f"invalid PNGs {invalid}, Samples {extra}")
    log(f"{label}: checkpoints {ckpts}; {len(scalars)} lines in "
        f"scalars.jsonl; {', '.join(g for g, _ in grids)} PNGs valid"
        + ("" if samples else "; no Samples grid"))
    return run_dir


def _tcache_check(root: str, patch: int) -> dict:
    """The transform cache on disk (``cache_transformed``) of the
    stand-in's train split: a first open transforms the split and writes
    ``tcache_train_c148_<patch>.npy`` beside the stand-in's file, a second
    maps that file and transforms nothing; the two hold the same bytes.
    Returns the seconds of each open and the file's size."""
    import numpy as np
    from ctvae_torch.data.disent_data import load_shapes3d
    from ctvae_torch.data.transforms import StandardTransform
    secs, opened = {}, []
    for how in ("build", "reopen"):
        t0 = time.perf_counter()
        opened.append(load_shapes3d(root, split="train",
                                    transform=StandardTransform(patch, 148),
                                    cache_transformed=True))
        secs[how] = time.perf_counter() - t0
    built, mapped = opened
    same = mapped.cache_file == built.cache_file is not None and \
        isinstance(mapped._cache, np.memmap) and \
        mapped._cache.shape == built._cache.shape and \
        bool(np.array_equal(mapped._cache, built._cache))
    out = {"rows": len(built), "build_s": secs["build"],
           "reopen_s": secs["reopen"],
           "file_mb": os.path.getsize(built.cache_file) / 1e6
           if built.cache_file else None}
    log(f"shapes3d transform cache: {out['rows']} rows of the train split "
        f"transformed and written to {os.path.basename(str(built.cache_file))}"
        f" ({out['file_mb']:.1f} MB) in {secs['build']:.3f} s, mapped again "
        f"in {secs['reopen']:.3f} s; built then reused "
        f"{built.cache_built} / {not mapped.cache_built}; rows byte-equal "
        f"{same}")
    if not (built.cache_built and not mapped.cache_built and same):
        raise AssertionError(f"shapes3d transform cache: {out}")
    return out


def phase_shapes3d() -> tuple:
    """The two headline configs from their own YAML through the port's
    entry points, on a Shapes3D stand-in written by the port's writer
    (numpy only) with its split and transition files: the transform
    cache of its train split written beside it and mapped again
    (``_tcache_check``); ``run.train`` of ``configs/mcq_vae.yaml``
    (Shapes3D, B = 64, ``codebooks: 4``: a full
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
    ``SHAPES3D_EPOCH_BATCHES`` steps in turns three ways (``_EpochOf``,
    ``SHAPES3D_TURNS``), which give the loader's share of the epoch. Returns the two paths'
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
        with wall("shapes3d.tcache"):
            tcache = _tcache_check(
                root, cfgs["mcq_vae"]["data_params"]["patch_size"])
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
            for how in SHAPES3D_TURNS:
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
    log(json.dumps({"shapes3d_pace": pace, "shapes3d_tcache": tcache}))
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
#: the sizes each metric is timed at on its own: ct_mcq_vae's are those
#: of the run.train that computes the four in (1)
METRIC_TIMED = ("mcq_vae",)
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
    mcq_vae's sample sizes (METRIC_TIMED), through the trained encoder (D =
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
        with wall("metrics.run"):
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

        # (2) each metric at mcq_vae's sizes, through the encoder
        t_part = time.perf_counter()
        model = build_model(cfg["model_params"], device="cuda")
        load_weights_only(os.path.join(run_dir, "checkpoints", "last"),
                          model)
        repr_fn = make_repr_fn(model)
        data = VAEDataset(**cfg["data_params"])
        data.setup()
        full = data.val_dataset._full_data
        D = int(repr_fn(full.transform.batch(full.images_raw[:1])).shape[1])
        seconds = {}
        for name in METRIC_TIMED:
            B, n_tr, n_te = METRIC_SIZES[name]
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
        WALL["metrics.timed"] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()
        _profile(f"DCI fit_gbt, {n_tr} x {D} codes, factor {j} "
                 f"({full.factor_sizes[j]} classes), 5 rounds",
                 lambda: fit_gbt(z_tr, y, n_estimators=5))
        WALL["metrics.profile"] = round(time.perf_counter() - t_part, 1)

        # (3) the card against the CPU on one table of codes
        t_part = time.perf_counter()
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
        WALL["metrics.vs_cpu"] = round(time.perf_counter() - t_part, 1)
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


# --- phase 12: the paper's hyperparameter search ----------------------------

SEARCH_CONFIG = os.path.join(os.path.dirname(CONFIG), os.pardir, "configs_hyp",
                             "ct_mcq_vae_hyp_search_shapes3d.yaml")
# the corners of the search space: noise x codebooks x the two smaller
# codebook sizes (64, the largest, is the headline's and phase "train"'s)
SEARCH_CORNERS = tuple((noise, cb, k) for noise in ("off", "endo")
                       for cb in (1, 2) for k in (16, 32))
SEARCH_TRIALS = 4          # the CLI's num_samples
SEARCH_LIMIT = 32          # per mode: 4 TShapes3D train batches of 8
SEARCH_VAL_LIMIT = 16      # per mode: 2 validation batches of 8
SEARCH_EPOCHS = 2          # asha: rung 1 trains 1 epoch, rung 2 two
EMA_OPTIONS = dict(ema=True, revive_threshold=0.5, grad_estimator="rotation")


def _search_config() -> dict:
    return read_config(os.path.normpath(SEARCH_CONFIG))


def _corner_params(noise: str, codebooks: int, k: int) -> dict:
    """The search config's model_params with each searched key at its
    first value, then the corner's noise, codebooks and codebook size."""
    cfg = _search_config()
    spec = cfg["hyperparameter_search"]["params"]["model_params"]
    params = {key: (value[0] if key in spec and isinstance(value, list)
                    else value)
              for key, value in cfg["model_params"].items()}
    params.update(noise=noise, codebooks=codebooks, num_embeddings=k)
    return params


def _search_expected(params: dict) -> dict:
    """Launches per train step of each mode: each quantizer call searches
    every codebook."""
    return {m: {**e, "vq_l2_argmin": params["codebooks"] * e["vq_l2_argmin"]}
            for m, e in EXPECTED_TRAIN.items()}


def _all_calls(fn, targets) -> dict:
    """``_calls_of`` for several (module, name) targets during one call
    of ``fn``: the calls by name."""
    calls = {}

    def run(i=0):
        if i == len(targets):
            fn()
            return
        module, name = targets[i]
        calls[name] = _calls_of(module, name, lambda: run(i + 1))
    run()
    return calls


def _step_kernel_calls(fn) -> dict:
    """The calls of every kernel but the VQ search's in one call of
    ``fn`` (a train step), by wrapper name."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops import pairwise_flash as pf
    return _all_calls(fn, [
        (pf, "flash_pairwise_cuda"), (pf, "flash_pairwise_bwd_cuda"),
        (gf, "flash_gat_cuda"), (gf, "flash_gat_bwd_cuda"),
        (gl, "fused_gat_logits_cuda"), (gl, "fused_gat_logits_bwd_cuda")])


def _plain_ms_on_step(fn) -> dict:
    """The plain versions' ms on the inputs each kernel gets in one call
    of ``fn`` (a train step): ``_plain_ms_of_calls``."""
    return _plain_ms_of_calls(_step_kernel_calls(fn))


def _plain_ms_of_calls(calls) -> dict:
    """The plain versions' ms on the inputs of a step's kernel calls
    (``_step_kernel_calls``): the pairwise and GAT forwards, the per-head
    logits forward, and the backwards' plain autograd (as the kernel
    rows' plain times are taken), by kernel (the pairwise ones by call)."""
    from ctvae_torch.ops.gat import gat_logits

    def det(args):
        return tuple(a.detach() if torch.is_tensor(a) else a for a in args)

    def which(args):
        return "no_inter" if args[2].dim() == 1 else "inter"

    out = {"pairwise_fwd": {}, "pairwise_bwd": {}}
    with torch.no_grad():
        for args, _ in calls["flash_pairwise_cuda"]:
            args = det(args)
            out["pairwise_fwd"][which(args)] = time_ms(
                lambda: _pairwise_fwd_plain(args), reps=5)
        (args, _), = calls["flash_gat_cuda"]
        args = det(args)
        out["gat_fwd"] = time_ms(lambda: _gat_fwd_plain(args), reps=5)
        ((*fargs, ns), _), = calls["fused_gat_logits_cuda"]
        fargs = det(fargs)
        out["gat_logits_fwd"] = time_ms(lambda: gat_logits(*fargs, ns),
                                        reps=5)
    for args, _ in calls["flash_pairwise_bwd_cuda"]:
        args = det(args)
        out["pairwise_bwd"][which(args)] = time_ms(
            lambda: _pairwise_plain_grads(args), reps=5)
    (args, _), = calls["flash_gat_bwd_cuda"]
    args = det(args)
    out["gat_bwd"] = time_ms(lambda: _gat_plain_grads(args), reps=5)
    ((*bargs, d_e, ns), _), = calls["fused_gat_logits_bwd_cuda"]
    leaves = [a.detach().clone().requires_grad_() for a in bargs]
    logits = gat_logits(*leaves, ns)
    out["gat_logits_bwd"] = time_ms(lambda: torch.autograd.grad(
        logits, leaves, d_e, retain_graph=True), reps=5)
    del calls, logits
    torch.cuda.empty_cache()
    return out


def _search_rows(label: str, mode: str, k: int, vq: list, found: dict,
                 plain: dict) -> dict:
    """One step's kernel calls as rows of the kernels line, by kernel:
    shape, ms, bound, plain ms (and ``cdist`` + ``argmin`` for VQ); the
    VQ and per-head logits rows also carry the codebook size ``k`` (the
    logits' F)."""
    def row(m, plain_ms, **extra):
        return {"step": f"{label} {mode}", "shape": m["shape"],
                "ms": m["ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "plain_ms": plain_ms, **extra}
    rows = {"vq_l2_argmin": [
        {"step": f"{label} {mode}", "shape": v["x"], "ms": v["ms"],
         "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
         "plain_ms": v["plain_ms"], "library_ms": v["library_ms"],
         "differ": v["differ"], "K": k} for v in vq]}
    rows["pairwise_fwd"] = [row(m, plain["pairwise_fwd"][w], call=w)
                            for w, m in found["pairwise_fwd"].items()]
    rows["pairwise_bwd"] = [row(m, plain["pairwise_bwd"][w], call=w,
                                live_pairs=m["live_pairs"])
                            for w, m in found["pairwise_bwd"].items()]
    g = found["gat_fwd"]
    rows["gat_fwd"] = [row(g, plain["gat_fwd"], nodes=g["shape"][1],
                           edge_density=g["edge_density"])]
    g = found["gat_bwd"]
    rows["gat_bwd"] = [row(g, plain["gat_bwd"], nodes=g["shape"][1],
                           edge_density=g["edge_density"])]
    for which in ("fwd", "bwd"):
        m = found["logits"][which]
        rows[f"gat_logits_{which}"] = [row(m, plain[f"gat_logits_{which}"],
                                           F=k)]
    return rows


def _search_corners() -> tuple:
    """Part (a): one model per corner of the search space at the search
    config's widths and B = 8; a warm and a timed train step per mode
    with the launch counters reset just before and read just after; then
    every kernel call of each mode's step held against its plain version
    on its own inputs (``_vq_on_path``, ``_kernels_on_step``) and the
    plain versions timed there. Returns (launches, ms per step by corner,
    kernel rows)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    cfg = _search_config()
    B = int(cfg["data_params"]["train_batch_size"])
    exp = cfg["exp_params"]
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    timings, rows = {}, {}
    gen = torch.Generator().manual_seed(SEED + 11)
    for noise, cb, k in SEARCH_CORNERS:
        label = f"{noise} codebooks={cb} K={k}"
        params = _corner_params(noise, cb, k)
        model = build_model(params, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        state = create_train_state(
            model, build_optimizers(exp, model, steps_per_epoch=100),
            seed=SEED)
        x, y, a = _requests(gen, B, "cuda")
        batch = {"image": x, "input_y": y, "action": a}
        steps = {m: make_train_step(m) for m in EXPECTED_TRAIN}
        _reset_counts()
        timings[label] = _timed_steps(f"search {label}", steps, state, batch,
                                      2, _search_expected(params))
        for name, n in _counts().items():
            launches[name] += n
        for mode, step in steps.items():
            def fn():
                return step(state, batch)
            vq = _vq_on_path(fn)
            found = _kernels_on_step(f"search {label} {mode}", fn)
            plain = _plain_ms_on_step(fn)
            log(f"search {label} {mode}: VQ {json.dumps(vq)}; plain ms "
                f"{json.dumps(plain)}")
            for name, r in _search_rows(label, mode, k, vq, found,
                                        plain).items():
                rows.setdefault(name, []).extend(r)
        del model, state, steps
        torch.cuda.empty_cache()
    return launches, timings, rows


def _graph_vs_eager(label: str, build, batches: list, mode: str,
                    M_N: float = 1.0) -> dict:
    """Three equal train states from ``build()``: 2K eager steps of
    ``mode`` on ``batches`` (2K batch dicts) from the first, again from
    the second (the control: eager steps must repeat bit for bit), and
    two ``make_multi_train_step(mode, K)`` calls from the third, under
    cuDNN's deterministic algorithms (the whole model trains, and a
    backbone trained on atomically summed weight gradients would make
    even two eager runs part ways). Every parameter, buffer and Adam
    moment, and each call's metrics against the eager step it ends on,
    within SCAN_RTOL of the largest magnitude; generators, steps and the
    replay count exact; raises otherwise. Returns the eager and graph
    states, the eager buffers before the steps, the eager steps' metrics
    and the differences by name."""
    from ctvae_torch.training import (make_multi_train_step,
                                      make_train_step)
    from ctvae_torch.training.state import WARMUP_STEPS
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, control, graph = (build() for _ in range(3))
        init = {n: t.clone() for n, t in eager.model.named_buffers()}
        step = make_train_step(mode, M_N=M_N)
        multi = make_multi_train_step(mode, SCAN_K, M_N=M_N)
        metrics = [step(eager, b) for b in batches]
        for b in batches:
            step(control, b)
        calls = [multi(graph, {k: torch.stack([b[k] for b in batches[h]])
                               for k in batches[0]})
                 for h in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K))]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b, c = (_scan_tensors(s) for s in (eager, graph, control))
    for i, m in enumerate(calls):
        for k, v in m.items():
            a[f"metric {(i + 1) * SCAN_K - 1}:{k}"] = \
                metrics[(i + 1) * SCAN_K - 1][k]
            b[f"metric {(i + 1) * SCAN_K - 1}:{k}"] = v
    repeat = [n for n in c if not torch.equal(a[n], c[n])]
    diffs = {n: float((a[n].float() - b[n].float()).abs().max()) for n in a}
    bad = {n: d for n, d in diffs.items() if d > SCAN_RTOL * max(
        float(a[n].float().abs().max()), 1e-30)}
    same_gen = torch.equal(eager.generator.get_state(),
                           graph.generator.get_state())
    n_metrics = sum(n.startswith("metric ") for n in diffs)
    log(f"{label}: {len(diffs) - n_metrics} parameters, buffers and Adam "
        f"moments after {2 * SCAN_K} steps and {n_metrics} metrics of the "
        f"calls' last steps, eager vs {multi.replays} replays (after "
        f"{WARMUP_STEPS} warm-up steps): "
        f"{sum(d == 0 for d in diffs.values())} bit-equal, largest "
        f"difference {max(diffs.values()):.3g}; generator equal "
        f"{same_gen}; step {eager.step} / {graph.step}; eager steps "
        f"repeated bit for bit: {not repeat} ({len(repeat)} tensors "
        f"differ)")
    if repeat:
        raise AssertionError(f"{label}: two eager runs differ in {repeat}")
    if bad or not same_gen or eager.step != graph.step or \
            multi.replays != 2 * SCAN_K - WARMUP_STEPS:
        raise AssertionError(f"{label}: graph and eager steps disagree: "
                             f"{bad}, generator {same_gen}, replays "
                             f"{multi.replays}")
    return {"eager": eager, "init": init, "metrics": metrics,
            "diffs": diffs}


def _search_ema_graph() -> dict:
    """Part (b): an EMA CT model (``EMA_OPTIONS``, noise endo, codebooks 2,
    K = 16) trained as the search trains it (every parameter), per train
    mode: ``_graph_vs_eager`` on 2K request batches, and the EMA buffers
    moved. cuDNN's deterministic algorithms matter most here: the EMA's
    code counts amplify any difference. Returns the largest difference
    by mode."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state
    cfg = _search_config()
    B = int(cfg["data_params"]["train_batch_size"])
    params = {**_corner_params("endo", 2, 16), **EMA_OPTIONS}
    gen = torch.Generator().manual_seed(SEED + 13)

    def build():
        model = build_model(params, device="cuda",
                            generator=torch.Generator(
                                "cuda").manual_seed(SEED))
        return create_train_state(model, build_optimizers(
            cfg["exp_params"], model, steps_per_epoch=100), seed=SEED)

    out = {}
    for mode in EXPECTED_TRAIN:
        batches = [dict(zip(("image", "input_y", "action"),
                            _requests(gen, B, "cuda")))
                   for _ in range(2 * SCAN_K)]
        r = _graph_vs_eager(f"search ema graph {mode}", build, batches,
                            mode)
        eager = r["eager"]
        moved = [n for n, t in eager.model.named_buffers()
                 if "quantizers_" in n and not torch.equal(t, r["init"][n])]
        revived = [int((t == 1.0).sum()) for n, t in
                   eager.model.named_buffers() if n.endswith("cluster_size")]
        log(f"search ema graph {mode}: EMA buffers moved {len(moved)}, "
            f"codes with a count of exactly 1 (revived at the last step) "
            f"{revived}")
        if len(moved) != 3 * params["codebooks"]:
            raise AssertionError(f"search ema graph {mode}: buffers moved "
                                 f"{moved}")
        out[mode] = max(r["diffs"].values())
        del r, eager
        torch.cuda.empty_cache()
    return out


def _flow(value) -> str:
    """``value`` as a YAML flow scalar / collection that ``read_config``
    reads back equal (strings quoted)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    if isinstance(value, tuple):
        return "!!python/tuple " + _flow(list(value))
    if isinstance(value, list):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    return "{" + ", ".join(f"{k}: {_flow(v)}" for k, v in value.items()) + "}"


def _write_config(cfg: dict, path: str) -> None:
    """A config file (sections as block mappings, values in flow form)
    that ``read_config`` reads back as ``cfg``; no PyYAML."""
    with open(path, "w") as f:
        for name, section in cfg.items():
            f.write(f"{name}:\n")
            for key, value in section.items():
                f.write(f"  {key}: {_flow(value)}\n")
    if read_config(path) != cfg:
        raise AssertionError(f"{path} does not read back as written")


def _search_cli(smi: str) -> tuple:
    """Part (c): ``python -m ctvae_torch.hyperparameter_search``'s
    ``main`` (in this process, so the launch counters see its kernels) on
    a copy of the search config with only ``data_path`` (a TShapes3D
    stand-in), ``num_samples``, ``limit``, ``val_limit``, ``max_epochs``,
    ``scheduler: asha`` and the log directory changed. Every trial must
    end with a finite loss and none may fail; ``results.json``'s best is
    the minimum; the trials take both noise values and both codebook
    counts. Returns (launches, its numbers)."""
    import tempfile
    from ctvae_torch import hyperparameter_search as hs
    from ctvae_torch.data.standins import write_shapes3d_standin
    with tempfile.TemporaryDirectory(prefix="ctvae_search_") as tmp:
        root, logs = os.path.join(tmp, "Data"), os.path.join(tmp, "logs")
        write_shapes3d_standin(root, SHAPES3D_GRID)
        cfg = _search_config()
        cfg["data_params"].update(data_path=root, limit=SEARCH_LIMIT,
                                  val_limit=SEARCH_VAL_LIMIT)
        cfg["trainer_params"]["max_epochs"] = SEARCH_EPOCHS
        cfg["logging_params"]["save_dir"] = logs
        cfg["hyperparameter_search"].update(num_samples=SEARCH_TRIALS,
                                            scheduler="asha")
        path = os.path.join(tmp, "search.yaml")
        _write_config(cfg, path)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code = hs.main(["-c", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        with open(os.path.join(logs, cfg["model_params"]["name"],
                               "hyp_search", "results.json")) as f:
            results = json.load(f)
    trials = sorted(results["trials"], key=lambda t: t["trial"])
    losses = [t["loss"] for t in trials]
    failed = [t for t in trials if "failed" in t]
    seen = {(t["params"]["model_params.noise"],
             t["params"]["model_params.codebooks"],
             t["params"]["model_params.num_embeddings"]) for t in trials}
    # rung 1 trains every trial one epoch, rung 2 the best 1 / eta two
    epochs = SEARCH_TRIALS + 2 * max(1, SEARCH_TRIALS // 2) - max(
        1, SEARCH_TRIALS // 2)
    numbers = {"wall_s": wall, "trial_epochs": epochs,
               "s_per_trial_epoch": wall / epochs, "losses": losses,
               "best": results["best"]["trial"] if results["best"] else None,
               "trials": sorted(seen), "card": smi}
    log(f"search cli: exit {code}, {len(trials)} trials in {wall:.1f} s "
        f"({epochs} trial epochs, {wall / epochs:.2f} s each; {smi}); "
        f"losses {losses}; best trial {numbers['best']}; (noise, "
        f"codebooks, K) drawn {sorted(seen)}")
    if code != 0 or failed or len(trials) != SEARCH_TRIALS or not all(
            math.isfinite(v) for v in losses) or results["best"]["loss"] != \
            min(losses) or {s[0] for s in seen} != {"off", "endo"} or \
            {s[1] for s in seen} != {1, 2}:
        raise AssertionError(f"search cli: exit {code}, failed {failed}, "
                             f"losses {losses}, drawn {sorted(seen)}")
    return launches, numbers


def phase_search(smi: str) -> tuple:
    """The paper's hyperparameter search on the card
    (``configs_hyp/ct_mcq_vae_hyp_search_shapes3d.yaml``): (a) the
    corners of its space, every kernel call held against its plain
    version; (b) an EMA model's captured graph against eager steps; (c)
    the search CLI's ASHA run. The launches of (a)'s timed steps and of
    (c) make the path ``search``. Returns (launches, the kernel rows by
    kernel, the numbers)."""
    start = time.perf_counter()
    launches, timings, rows = walled("search.corners", _search_corners)
    t_a = time.perf_counter() - start
    ema = walled("search.ema", _search_ema_graph)
    t_b = time.perf_counter() - start - t_a
    cli_launches, numbers = walled("search.cli", _search_cli, smi)
    for name, n in cli_launches.items():
        launches[name] += n
    log(f"launches on the search path: {json.dumps(launches)}")
    numbers.update(ms_per_step=timings, ema_graph_max_diff=ema)
    log(f"search: phase {time.perf_counter() - start:.1f} s (corners "
        f"{t_a:.1f}, EMA graph {t_b:.1f}, cli {numbers['wall_s']:.1f})")
    return launches, rows, numbers


# --- phase 14: VQVAE and the Gaussian zoo from their YAML -------------------

GAUSSIAN_BATCH = 64        # the batch of every zoo config
#: configs trained one epoch through run.train (phase "celeba" trains
#: vae.yaml and vq_vae.yaml, on the same stand-in, as written): lvae for
#: its [B, D] BatchNorm and its own decoder, gammavae for the gamma draw,
#: gradient_clip_val 0.8 and weight_decay 5e-5, cat_vae for the step in
#: the forward and its 20,480-wide fc_z
GAUSSIAN_RUNS = ("lvae", "gammavae", "cat_vae")
#: the zoo's members whose steps make the paths gaussian_vq (VQVAE's VQ
#: search at K = 512) and gaussian
ZOO_BASE = ("vae", "vq_vae")
#: the zoo's loss-only members, each a warm and timed eager train steps
ZOO_CONFIGS = ("bbvae", "bhvae", "logcosh_vae", "dip_vae", "infovae",
               "wae_mmd_imq", "wae_mmd_rbf")
#: the zoo's members with their own architecture or draws: each a
#: warm and timed eager train steps, and its serving against the CPU
ZOO_MORE = ("iwae", "miwae", "swae", "betatc_vae", "cat_vae", "joint_vae",
            "gammavae", "vampvae", "hvae", "lvae")
#: the first step from which a config's zoo steps (DIVERGE_IN_STEPS) or
#: epoch (DIVERGE_IN_EPOCHS) may be non-finite, each from a reference that
#: diverges there; the steps before it must be finite, and a non-finite
#: step must be non-finite on the CPU too from the same state
#: (_NonfiniteWatch). iwae's, vampvae's, hvae's and lvae's KL blows up at
#: the second step at LR 0.007 / 0.005, in JAX as in the port (tier-1
#: test_torch_zoo_more.py::test_yaml_lr_blows_up_in_jax_as_in_the_port);
#: vq_vae's VQ loss passes 1e3 times the first step's by the third (tier-1
#: test_torch_zoo.py::test_vq_vae_yaml_steps_match_jax_at_full_width);
#: gammavae's gradient passes f32's range once a softmax rate falls to
#: ~1e-19, which its epoch at manual_seed 1265 reached at step 6 on the
#: card (tier-1 test_torch_zoo_more.py::test_gamma_vae_gradient_overflows_
#: in_jax_as_in_the_port). Every other config must stay finite
DIVERGE_IN_STEPS = {"iwae": 1, "vampvae": 1, "hvae": 1, "lvae": 1}
DIVERGE_IN_EPOCHS = {"vq_vae": 2, "lvae": 1, "gammavae": 1}
ZOO_TIMED_STEPS = 5        # timed eager steps per model after the warm one
GAUSSIAN_SERVE_B = 16
#: the last of the registry: MSSIMVAE (MS-SSIM), DFCVAE (the frozen
#: VGG19-bn, model_params.allow_random_features set: no weights can be
#: fetched) and FactorVAE (LR_2 / submodel: two optimizer calls a batch)
ZOO_LAST = ("mssim_vae", "dfc_vae", "factorvae")
#: of these, trained one epoch through run.train on the first
#: LAST_EPOCH_STEPS batches of the stand-in's train split
LAST_RUNS = ("dfc_vae", "factorvae")
# reruns on the card of FactorVAE's first step from one state (its
# discriminator's card-vs-CPU check once read 1.03 of its tolerance): the
# spread of the card's gradients, 0 under deterministic cuDNN
FACTORVAE_RERUNS = 4
LAST_EPOCH_STEPS = 50     # the first step that logs (log_every 50)
#: the turns of the epochs that pace the CelebA configs (ABBA)
PACE_TURNS = ("held", "inline", "inline", "held")
LAST_VAL_BATCHES = 10


def _gaussian_config(name: str, root: str, logs: str) -> dict:
    """``configs/<name>.yaml`` as ``read_config`` reads it, with only
    ``data_path`` (the CelebA stand-in under ``root``), one epoch and the
    log directory changed: ``dataset_name: Celeba``, ``patch_size: 64``,
    the model, the exp_params and the batch of 64 as written. The
    trainer's ``gradient_clip_val`` stays where run.train moves it
    from."""
    cfg = read_config(os.path.join(os.path.dirname(CONFIG), f"{name}.yaml"))
    written = dict(cfg["data_params"])
    cfg["data_params"] = {**cfg["data_params"], "data_path": root}
    cfg["trainer_params"] = {**cfg["trainer_params"], "max_epochs": 1}
    cfg["logging_params"] = {**cfg["logging_params"], "save_dir": logs}
    dp = cfg["data_params"]
    if (dp["train_batch_size"], dp["dataset_name"], dp["patch_size"]) != (
            GAUSSIAN_BATCH, "Celeba", 64):
        raise AssertionError(f"{name}: data_params {dp}")
    log(f"{name}: data_params as written {json.dumps(written)} but "
        f"data_path (the CelebA stand-in); model_params "
        f"{json.dumps(cfg['model_params'])}")
    return cfg


def _gaussian_serve(model, label: str = "gaussian",
                    atol: float = SERVE_ATOL,
                    sample_overflows: bool = False) -> dict:
    """A Gaussian model's ``reconstruct``, ``encode`` and ``sample`` at B
    = 16 (with 0 / 1 labels of 40 attributes for a model that
    ``needs_labels``): each request timed on the card, its output finite,
    and held against the same weights on the CPU within ``atol``, the
    model call of every entry point on the same CPU-drawn draws on both
    (``_replay_draws``:
    IWAE's samples, HVAE's z2 in ``encode``, the gamma and Gumbel
    draws): the same elements non-finite on both sides, the rest within
    ``atol``. With ``sample_overflows`` (LVAE at random init, whose prior
    samples reach non-finite latents in JAX as in the port: tier-1
    test_torch_zoo_more.py::test_lvae_prior_samples_overflow_in_jax_as_
    in_the_port) a ``sample`` request may hold non-finite rows; they are
    counted."""
    from ctvae_torch.serving.inference import available_fns, encode_repr, \
        make_inference_fn
    if available_fns(model) != ("reconstruct", "encode", "sample"):
        raise AssertionError(f"serve: {available_fns(model)}")
    cpu_model = copy.deepcopy(model).to("cpu")
    Bs = GAUSSIAN_SERVE_B
    gen = torch.Generator().manual_seed(SEED + 21)
    x = torch.rand(Bs, 64, 64, 3, generator=gen)
    labels = ((torch.randint(0, 2, (Bs, 40), generator=gen).float(),)
              if getattr(model, "needs_labels", False) else ())
    on_card = tuple(t.cuda() for t in labels)
    fns = {n: make_inference_fn(model, n, num_samples=Bs)
           for n in ("reconstruct", "encode", "sample")}
    dgen = torch.Generator("cuda").manual_seed(SEED)
    calls = {"reconstruct": lambda: fns["reconstruct"](
        x.cuda(), *on_card, generator=dgen),
        "encode": lambda: fns["encode"](x.cuda(), *on_card, generator=dgen),
        "sample": lambda: fns["sample"](*on_card, generator=dgen)}
    # each entry point's model call, on given draws
    direct = {
        "reconstruct": lambda m, x, labels, draws: (
            m(x, *labels, draws=draws) if labels else
            m(x, mode="base", draws=draws))["recons"],
        "encode": lambda m, x, labels, draws: (
            m.encode_labeled(x, *labels)[0].flatten(1) if labels else
            encode_repr(m, x, draws)),
        "sample": lambda m, x, labels, draws: m.sample(Bs, *labels,
                                                       draws=draws)}
    ms, errs, nonfinite = {}, {}, {}
    for name, call in calls.items():
        secs, rows = [], 0
        for _ in range(REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            secs.append(1e3 * (time.perf_counter() - t0))
            rows += int((~torch.isfinite(out.reshape(Bs, -1)).all(1)).sum())
        if rows and not (name == "sample" and sample_overflows):
            raise AssertionError(f"serve {name}: {rows} non-finite rows")
        ms[name] = statistics.median(secs[1:])
        with torch.inference_mode():
            got = direct[name](model, x.cuda(), on_card,
                               _replay_draws("cuda", SEED)).cpu()
            want = direct[name](cpu_model, x, labels,
                                _replay_draws("cpu", SEED))
        finite = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), finite):
            raise AssertionError(f"serve {name}: card and CPU non-finite "
                                 f"in other elements")
        errs[name] = float((got - want)[finite].abs().max()) \
            if bool(finite.any()) else 0.0
        nonfinite[name] = rows
        log(f"{label} serve {name} B={Bs}"
            f"{' with labels' if labels else ''}: {ms[name]:.3f} ms per "
            f"request (median of {REQUESTS - 1} after a warm-up); card vs "
            f"CPU max abs err {errs[name]:.3g} (tolerance {atol}) over "
            f"{int(finite.sum())} of {want.numel()} finite elements, shape "
            f"{list(out.shape)}; {rows} non-finite rows in the "
            f"{REQUESTS} timed requests")
        if not errs[name] <= atol:
            raise AssertionError(f"serve {name}: card and CPU disagree by "
                                 f"{errs[name]}")
    return {"ms": ms, "max_abs_err": errs, "nonfinite_rows": nonfinite}


def _exp_params(cfg: dict) -> dict:
    """``cfg``'s exp_params with the trainer's ``gradient_clip_val`` moved
    in, as run.train moves it."""
    exp = dict(cfg["exp_params"])
    if "gradient_clip_val" in cfg["trainer_params"]:
        exp.setdefault("gradient_clip_val",
                       cfg["trainer_params"]["gradient_clip_val"])
    return exp


def _replay_taken(taken: list, device):
    """A ``Draws`` provider on ``device`` that gives back ``taken``, the
    (kind, tensor) draws of one step in the order they were taken, each
    held to the kind and shape asked for; ``left()`` counts those not
    given back."""
    from ctvae_torch.models.base import Draws
    taken = list(taken)

    class Taken(Draws):
        def _next(self, kind, shape):
            k, t = taken.pop(0)
            if (k, tuple(t.shape)) != (kind, tuple(shape)):
                raise AssertionError(f"replay: {kind} {tuple(shape)} asked "
                                     f"where {k} {tuple(t.shape)} was drawn")
            return t.to(self.device)

        def uniform(self, shape):
            return self._next("uniform", shape)

        def normal(self, shape):
            return self._next("normal", shape)

        def randint(self, low, high, shape):
            return self._next("randint", shape)

        def gamma(self, alpha):
            return self._next("gamma", alpha.shape)

        def cauchy(self, shape):
            return self._next("cauchy", shape)

        def left(self):
            return len(taken)

    return Taken(None, torch.device(device))


class _NonfiniteWatch:
    """Within ``with``, every eager train step on the card is watched: its
    draws kept as the card took them, its buffers kept from before its
    forward, and its metrics read (one host read a step). At the first
    step whose metrics are not all finite (``first``: its step number)
    its gradients and metrics are computed again on the CPU from the
    card's parameters and buffers before it, on its batch, its step and
    the card's draws: the CPU must be non-finite in the same metrics and
    within 1e-3 of the card's finite ones (one step's rounding from one
    state), or the step raises. So a run on the card turns non-finite
    only where the port's CPU path, which the tier-1 tests hold against
    JAX's step on the same draws, does too."""

    def __init__(self, label: str):
        self.label, self.first, self.taken = label, None, []

    def __enter__(self):
        from ctvae_torch.training import state as tstate
        self._tstate, self._grads, self._draws = (tstate, tstate._grads,
                                                  tstate.Draws)
        watch = self

        class Kept(tstate.Draws):
            def uniform(self, shape):
                return watch._keep("uniform", super().uniform(shape))

            def normal(self, shape):
                return watch._keep("normal", super().normal(shape))

            def randint(self, low, high, shape):
                return watch._keep("randint",
                                   super().randint(low, high, shape))

            def gamma(self, alpha):
                return watch._keep("gamma", super().gamma(alpha))

            def cauchy(self, shape):
                return watch._keep("cauchy", super().cauchy(shape))

        tstate.Draws, tstate._grads = Kept, self._watched
        return self

    def __exit__(self, *exc) -> bool:
        self._tstate.Draws, self._tstate._grads = self._draws, self._grads
        return False

    def _keep(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        self.taken.append((kind, t.clone()))
        return t

    def _watched(self, state, batch, mode, M_N, step, optimizer_idx=0):
        model = state.model
        if self.first is not None or model.device.type != "cuda":
            return self._grads(state, batch, mode, M_N, step, optimizer_idx)
        buffers = [b.clone() for b in model.buffers()]
        self.taken = []
        metrics = self._grads(state, batch, mode, M_N, step, optimizer_idx)
        if all(torch.stack([torch.isfinite(v).all()
                            for v in metrics.values()]).tolist()):
            return metrics
        self.first = int(step)
        cpu = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            for b, kept in zip(cpu.buffers(), buffers):
                b.copy_(kept)
        replay = _replay_taken(self.taken, "cpu")
        self._tstate.Draws = lambda generator, device: replay
        try:
            want = self._grads(
                self._tstate.TrainState(step=0, model=cpu, optimizers=[],
                                        generator=None),
                {k: v.cpu() for k, v in batch.items()}, mode, M_N,
                step.cpu(), optimizer_idx)
        finally:
            self._tstate.Draws = self._draws
        errs = {}
        for k, v in metrics.items():
            got, w = v.detach().cpu(), want[k].detach()
            fin = torch.isfinite(w)
            err = (got - w).abs() - 1e-3 * w.abs()
            errs[k] = float(err[fin].max()) if bool(fin.any()) else 0.0
            if not torch.equal(torch.isfinite(got), fin) or errs[k] > 1e-6:
                raise AssertionError(
                    f"{self.label} step {self.first}: card {got} and CPU "
                    f"{w} from the same state disagree in {k}")
        if replay.left():
            raise AssertionError(f"{self.label} step {self.first}: "
                                 f"{replay.left()} draws not replayed")
        log(f"{self.label}: first non-finite step {self.first}, on the "
            f"card as on the CPU from the same parameters, buffers, batch "
            f"and {len(self.taken)} draws: "
            f"{json.dumps({k: float(v) for k, v in want.items() if v.dim() == 0})}")
        return metrics


def _train_step_vs_cpu(name: str, cfg: dict, batch: dict,
                       build=None, reruns: int = 0) -> dict:
    """``_step_vs_cpu`` under cuDNN's deterministic algorithms. Without
    them the card's first call varies from run to run in its last bits,
    Adam turns a gradient of rounding noise (a conv bias before a
    BatchNorm) into a step of up to LR, and a second call (FactorVAE's
    discriminator) is compared from a state that differs between runs:
    its card-vs-CPU error read 1.03 and 8e-5 of the tolerance in two
    runs, while reruns from one state spread by less than 0.004 of it."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _step_vs_cpu(name, cfg, batch, build, reruns)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _step_vs_cpu(name: str, cfg: dict, batch: dict, build=None,
                 reruns: int = 0) -> dict:
    """The first train step of ``cfg``'s model at full width (its
    model_params and _exp_params: the clip and the weight decay as
    run.train takes them) on ``batch`` on the card against the same step
    on the CPU: the same initial weights, and on the CPU the draws the
    card took (kept by a _NonfiniteWatch, replayed). The metrics within
    rtol 1e-4 (atol 1e-6) and the BatchNorm buffers within 1e-5 + 1e-4
    relative, as the card test test_zoo_train_step_on_card_matches_cpu
    holds its small models; each gradient within 1e-3 of max(1, its
    block's largest), the scale the tier-1 zoo tests take (a conv bias
    right before a BatchNorm has a gradient of exactly zero in exact
    arithmetic, so both sides compute rounding noise of the block's own
    terms: at full width the decoder's last block sums over up to 3.9M
    positions, 960 images for MIWAE, whose last deconv bias card and CPU
    put 1.2e-4 apart, hence 1e-3 where the card test's small models take
    1e-4); each parameter after the
    card's update within 1e-6 of the
    CPU's optimizer (clip, Adam) applied to the same initial parameters
    and the card's own gradients. (Adam maps a gradient of rounding noise,
    as a conv bias before a BatchNorm gets, to a step of up to LR times
    |g| / 1e-8, so two sides' parameters are held through their gradients,
    not to each other.) With two optimizers (FactorVAE's ``LR_2`` /
    ``submodel``) the batch's two calls in turn, the second from the
    card's state after the first on both sides (its parameters and
    buffers copied to the CPU), and the second call must leave every
    parameter outside its optimizer bit-unchanged on the card.
    ``build(generator)`` makes the model where it is no registry config's
    (TwoStageVAE). With ``reruns`` each call is taken that many times
    again on the card from the card's state before it with the same
    draws, and each gradient's largest distance from the card's first
    run over the same tolerance is its spread (``rerun_spread``: the
    largest, with the three widest gradients and their card-vs-CPU error
    beside it). Returns the largest errors, each over its tolerance."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    from ctvae_torch.training import state as tstate
    exp = _exp_params(cfg)
    M_N = float(exp.get("kld_weight", 1.0))
    if build is None:
        def build(gen):
            return build_model(cfg["model_params"], device="cuda",
                               generator=gen)
    model = build(torch.Generator("cuda").manual_seed(SEED))
    cpu_model = copy.deepcopy(model).to("cpu")
    on_card_grads = copy.deepcopy(cpu_model)
    states = {side: create_train_state(m, build_optimizers(
        exp, m, steps_per_epoch=100), seed=SEED)
        for side, m in (("card", model), ("cpu", cpu_model))}
    reference = build_optimizers(exp, on_card_grads, steps_per_epoch=100)
    worst = {"metrics": 0.0, "grads": 0.0, "params": 0.0, "buffers": 0.0}

    def hold(kind, what, err):
        worst[kind] = max(worst[kind], float(err.max()))
        if not worst[kind] <= 1.0:
            i = int(err.flatten().argmax())
            raise AssertionError(f"{name} step on card vs CPU: {kind} of "
                                 f"{what} off by {float(err.max()):.3g} of "
                                 f"its tolerance at element {i}")

    t0, taken, n_opt = time.perf_counter(), 0, len(reference)
    spreads = []
    for idx in range(n_opt):
        # both sides (and the reference update) from the card's state
        with torch.no_grad():
            for m in (cpu_model, on_card_grads):
                for t, c in zip(model.state_dict().values(),
                                m.state_dict().values()):
                    c.copy_(t.cpu())
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        pre = copy.deepcopy(model.state_dict()) if reruns else None
        step0 = states["card"].step
        metrics, grads = {}, {}
        for side, m in (("card", model), ("cpu", cpu_model)):
            step = make_train_step("base", M_N=M_N, optimizer_idx=idx)
            b = {k: v.to(m.device) for k, v in batch.items()}
            if side == "card":
                with _NonfiniteWatch(f"gaussian {name} first step call "
                                     f"{idx}") as watch:
                    out = step(states[side], b)
                replay = _replay_taken(watch.taken, "cpu")
                taken += len(watch.taken)
            else:
                kept = tstate.Draws
                tstate.Draws = lambda generator, device: replay
                try:
                    out = step(states[side], b)
                finally:
                    tstate.Draws = kept
            metrics[side] = {k: float(v) for k, v in out.items()
                             if v.dim() == 0}
            grads[side] = {n: p.grad.detach().cpu()
                           for n, p in m.named_parameters()
                           if p.grad is not None}
        if replay.left():
            raise AssertionError(f"{name}: {replay.left()} draws not "
                                 f"replayed")
        if metrics["card"].keys() != metrics["cpu"].keys() or \
                grads["card"].keys() != grads["cpu"].keys():
            raise AssertionError(f"{name}: metrics {list(metrics['card'])} "
                                 f"/ {list(metrics['cpu'])}")
        for k, v in metrics["cpu"].items():
            hold("metrics", k, torch.tensor(abs(metrics["card"][k] - v)
                                            / (1e-6 + 1e-4 * abs(v))))
        scale = {}
        for n, g in grads["cpu"].items():
            block = n.rsplit(".", 2)[0]
            scale[block] = max(scale.get(block, 1.0), float(g.abs().max()))
        cpu_err = {n: (grads["card"][n] - g).abs()
                   / (1e-3 * scale[n.rsplit(".", 2)[0]])
                   for n, g in grads["cpu"].items()}
        if reruns:
            spreads.append(_rerun_spread(
                model, pre, exp, M_N, idx, step0, watch.taken, batch,
                grads["card"], scale, cpu_err, reruns))
        for n, err in cpu_err.items():
            hold("grads", n, err)
        for n, p in on_card_grads.named_parameters():
            p.grad = grads["card"].get(n)
        reference[idx].step()
        updated = dict(on_card_grads.named_parameters())
        for n, p in model.named_parameters():
            hold("params", n, (p.detach().cpu() - updated[n].detach()).abs()
                 / 1e-6)
        cpu_buffers = dict(cpu_model.named_buffers())
        for n, b in model.named_buffers():
            w = cpu_buffers[n]
            hold("buffers", n, (b.cpu() - w).abs() / (1e-5 + 1e-4 * w.abs()))
        held = {id(p) for p in states["card"].optimizers[idx].params}
        moved = [n for n, p in model.named_parameters()
                 if id(p) not in held and not torch.equal(p, before[n])]
        if moved:
            raise AssertionError(f"{name} call {idx}: parameters outside "
                                 f"its optimizer moved: {moved[:4]}")
    log(f"gaussian {name}: the first train step at B={len(batch['image'])} "
        f"({n_opt} optimizer call{'s' if n_opt > 1 else ''}"
        f"{', the second moving its submodel alone' if n_opt > 1 else ''}"
        f") on the card vs the CPU on the same weights and the card's "
        f"{taken} draws, largest error over its tolerance "
        f"{json.dumps(worst)} ({len(grads['cpu'])} gradients, "
        f"{sum(1 for _ in model.buffers())} buffers; "
        f"{time.perf_counter() - t0:.1f} s with the CPU step); loss "
        f"{metrics['card']['loss']:.6g}")
    if reruns:
        worst["rerun_spread"] = max(sp["spread"] for sp in spreads)
        log(f"gaussian {name}: the card's gradients over {reruns} reruns "
            f"of each call from the same state and draws, largest distance "
            f"from the first run over the card-vs-CPU tolerance, per call: "
            f"{json.dumps(spreads)}")
    del model, cpu_model, on_card_grads, states
    torch.cuda.empty_cache()
    return worst


def _rerun_spread(model, pre, exp, M_N, idx, step0, taken, batch, first,
                  scale, cpu_err, reruns) -> dict:
    """``_step_vs_cpu``'s call ``idx`` taken ``reruns`` times again
    on a copy of the card's model from its state before the call
    (``pre``) with the draws the first run took: each gradient's largest
    distance from the first run's (``first``) over the card-vs-CPU
    tolerance (1e-3 of its block's scale); the largest, and the three
    widest gradients with their card-vs-CPU error (``cpu_err``)."""
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    from ctvae_torch.training import state as tstate
    rerun = copy.deepcopy(model)
    spread: dict = {}
    for _ in range(reruns):
        rerun.load_state_dict(pre)
        st = create_train_state(rerun, build_optimizers(
            exp, rerun, steps_per_epoch=100), seed=SEED)
        st.step = step0
        kept = tstate.Draws
        tstate.Draws = lambda generator, device: _replay_taken(taken, "cuda")
        try:
            make_train_step("base", M_N=M_N, optimizer_idx=idx)(
                st, {k: v.to("cuda") for k, v in batch.items()})
        finally:
            tstate.Draws = kept
        for n, p in rerun.named_parameters():
            if p.grad is None or n not in first:
                continue
            d = float(((p.grad.detach().cpu() - first[n]).abs()
                       / (1e-3 * scale[n.rsplit(".", 2)[0]])).max())
            spread[n] = max(spread.get(n, 0.0), d)
    widest = sorted(spread, key=spread.get, reverse=True)[:3]
    del rerun
    torch.cuda.empty_cache()
    return {"call": idx, "spread": max(spread.values(), default=0.0),
            "widest": {n: {"spread": spread[n],
                           "card_vs_cpu": float(cpu_err[n].max())}
                       for n in widest}}


def _vgg_bound_ms(vgg, B: int, size: int) -> float:
    """The least time of a DFCVAE train step's VGG convolutions at the f32
    peak: 2 x H x W x C_in x C_out x 9 operations per conv and image (an
    fma = 2), the forward on the 2B reconstructions and inputs and the
    data gradient on the B reconstructions."""
    flops, hw = 0, size
    for idx, (kind, _) in enumerate(vgg.plan[:vgg.last + 1]):
        if kind == "pool":
            hw //= 2
        elif kind == "conv":
            w = getattr(vgg, f"conv{idx}_weight")
            flops += 2 * hw * hw * w.shape[0] * w.shape[1] * 9
    return 1e3 * flops * 3 * B / F32_FLOPS


def _zoo_step(name: str, cfg: dict, batch: dict) -> dict:
    """``cfg``'s model at B = 64 (its model_params and _exp_params): a warm
    eager train step at ``M_N`` = kld_weight, then ZOO_TIMED_STEPS timed
    ones (median), all under a _NonfiniteWatch: the losses finite, or
    non-finite from DIVERGE_IN_STEPS' step on as on the CPU from the same
    state; one step profiled (device-busy share, top kernels); peak
    memory. A step of a model with two optimizers (FactorVAE) is the
    batch's two calls; a frozen VGG (DFCVAE's) must end bit-unchanged."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    exp = _exp_params(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg["model_params"], device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(model, build_optimizers(
        exp, model, steps_per_epoch=100), seed=SEED)
    calls = [make_train_step("base", M_N=float(exp.get("kld_weight", 1.0)),
                             optimizer_idx=i)
             for i in range(len(state.optimizers))]
    vgg = {n: t.clone() for n, t in model.named_buffers()
           if n.startswith("feature_network.")}

    def step(state, batch):
        for call in calls:
            out = call(state, batch)
        return out

    secs, losses = [], []
    with _NonfiniteWatch(f"zoo {name}") as watch:
        for _ in range(1 + ZOO_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            losses.append(float(out["loss"]))
            secs.append(1e3 * (time.perf_counter() - t0))
    frozen = dict(model.named_buffers())
    if any(not torch.equal(frozen[n], t) for n, t in vgg.items()):
        raise AssertionError(f"zoo {name}: the frozen VGG's buffers moved")
    allowed = DIVERGE_IN_STEPS.get(name)
    if watch.first is not None and (allowed is None
                                    or watch.first < allowed):
        raise AssertionError(f"zoo {name}: non-finite from step "
                             f"{watch.first}; losses {losses}")
    stats = {}
    rows = _profile(f"zoo {name} train step B={GAUSSIAN_BATCH}",
                    lambda: step(state, batch), stats=stats)
    res = {"model": cfg["model_params"]["name"],
           "ms_per_step": statistics.median(secs[1:]),
           "busy_share": stats["busy_ms"] / stats["wall_ms"],
           "device_ms": stats["busy_ms"],
           "kernels_per_step": sum(r[2] for r in rows),
           "top_kernels": [[k[:60], round(ms, 4)] for k, ms, _ in rows[:3]],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "nonfinite_from_step": watch.first,
           "clip": exp.get("gradient_clip_val"),
           "optimizer_calls_per_step": len(calls)}
    if vgg:
        res["vgg_buffers_unchanged"] = len(vgg)
        res["vgg_conv_bound_ms"] = _vgg_bound_ms(
            model.feature_network, len(batch["image"]),
            batch["image"].shape[1])
        log(f"zoo {name}: the VGG's convolutions need at least "
            f"{res['vgg_conv_bound_ms']:.3f} ms at {F32_FLOPS / 1e12:.0f} "
            f"TFLOP/s (f32), against {res['device_ms']:.3f} ms of device "
            f"time in the profiled step")
    log(f"zoo {name} ({res['model']}) B={GAUSSIAN_BATCH}: "
        f"{res['ms_per_step']:.3f} ms per eager train step (median of "
        f"{ZOO_TIMED_STEPS} after a warm one, each watched), device busy "
        f"{100 * res['busy_share']:.1f}% of the profiled step, peak "
        f"{res['peak_gib']:.3f} GiB, losses {losses}")
    del model, state
    return res


def _vq_rows(state, batch) -> dict:
    """Every VQ search call of a VQVAE train step and of its eval step
    held against the plain version on its own inputs (``_vq_on_path``);
    the K = 512 line of the kernel's row."""
    from ctvae_torch.ops import vq
    from ctvae_torch.training import make_eval_step, make_train_step
    calls = {"train": _vq_on_path(lambda: make_train_step("base")(
        state, batch)),
        "eval": _vq_on_path(lambda: make_eval_step("base")(state, batch))}
    if [len(v) for v in calls.values()] != [1, 1]:
        raise AssertionError(f"vq calls {calls}")
    K, D = state.model.num_embeddings, state.model.embedding_dim
    occ = vq.occupancy(K, D)
    log(f"vq occupancy at K={K} D={D}: {json.dumps(occ)}")
    rows = {}
    for which, (c,) in calls.items():
        rows[which] = {**c, "K": K, "occupancy": occ}
        log(f"gaussian vq_vae {which} step: VQ search {json.dumps(c)}")
    return rows


def _gaussian_graph(name: str, cfg: dict, batches: list) -> float:
    """``_graph_vs_eager`` of ``cfg``'s model in mode base at the YAML's
    ``kld_weight``, with BatchNorm buffers present. For BetaVAE B the
    capacity runs over the 2K steps (``Capacity_max_iter`` 2K) up to
    twice the first step's KLD, so that C, which each replay must read
    from its own step, crosses the KLD among the replayed steps: a graph
    that froze C would differ in the loss and, after the crossing, in
    the gradients' sign. For CategoricalVAE the temperature, which the
    forward reads from the step, rises every 2 steps (``anneal_rate``
    -0.05, ``anneal_interval`` 2: the YAML's positive rate holds it at its
    clamp whatever the step), so a graph that froze the step would
    sample at another temperature. GammaVAE's gamma draw runs under the
    capture. Returns the largest difference."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    from ctvae_torch.training.state import WARMUP_STEPS
    exp, mp = cfg["exp_params"], dict(cfg["model_params"])
    M_N = float(exp.get("kld_weight", 1.0))
    batches = [{"image": b["image"]} for b in batches]

    def build():
        model = build_model(mp, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        return create_train_state(model, build_optimizers(
            exp, model, steps_per_epoch=100), seed=SEED)

    if mp["name"] == "CategoricalVAE":
        mp.update(anneal_rate=-0.05, anneal_interval=2)
        taus = [0.5 * math.exp(0.05 * (s - s % 2)) for s in range(2 * SCAN_K)]
        log(f"gaussian graph {name}: temperature by step "
            f"{[round(t, 4) for t in taus]} (anneal_rate -0.05, "
            f"anneal_interval 2)")
    capacity = mp.get("loss_type") == "B"
    if capacity:
        kld0 = float(make_train_step("base", M_N=M_N)(
            build(), batches[0])["KLD"])
        mp.update(Capacity_max_iter=2 * SCAN_K, max_capacity=2.0 * kld0)
    r = _graph_vs_eager(f"gaussian graph {name}", build, batches, "base",
                        M_N)
    n_bn = sum(n.endswith(("running_mean", "running_var"))
               for n, _ in r["eager"].model.named_buffers())
    log(f"gaussian graph {name}: {n_bn} BatchNorm buffers compared")
    if not n_bn:
        raise AssertionError(f"gaussian graph {name}: no BatchNorm buffers")
    if capacity:
        C = [min(mp["max_capacity"] / mp["Capacity_max_iter"] * (s + 1),
                 mp["max_capacity"]) for s in range(2 * SCAN_K)]
        above = [float(m["KLD"]) > c for m, c in zip(r["metrics"], C)]
        log(f"gaussian graph {name}: capacity C up to {C[-1]:.4g} over "
            f"{2 * SCAN_K} steps; KLD above C at steps "
            f"{[s for s, u in enumerate(above) if u]}")
        if len(set(above[WARMUP_STEPS:])) != 2:
            raise AssertionError(f"gaussian graph {name}: C never crosses "
                                 f"the KLD among the replayed steps")
    out = max(r["diffs"].values())
    del r
    torch.cuda.empty_cache()
    return out


def _celeba_subset(root: str, dst: str, n_train: int, n_test: int) -> str:
    """A CelebA root under ``dst`` over the first ``n_train`` train and
    ``n_test`` test files of ``root``'s split (its image folder and
    attributes linked); returns ``dst``."""
    src, out = os.path.join(root, "celeba"), os.path.join(dst, "celeba")
    os.makedirs(out, exist_ok=True)
    for name in ("img_align_celeba", "list_attr_celeba.txt"):
        if os.path.exists(os.path.join(src, name)):
            os.symlink(os.path.join(src, name), os.path.join(out, name))
    left = {0: n_train, 2: n_test}
    with open(os.path.join(src, "list_eval_partition.txt")) as f, \
            open(os.path.join(out, "list_eval_partition.txt"), "w") as g:
        for line in f:
            parts = line.split()
            if len(parts) == 2 and left.get(int(parts[1]), 0) > 0:
                left[int(parts[1])] -= 1
                g.write(line)
    return dst


def _vgg_refusal(cfg: dict, logs: str) -> dict:
    """``configs/dfc_vae.yaml`` as written (no ``allow_random_features``)
    through ``run.train`` where no VGG19-bn weights exist: it must raise
    the refusal that names ``allow_random_features`` before training.
    Where weights exist (``find_pretrained_weights``) there is nothing to
    refuse, and that is logged."""
    from ctvae_torch import run
    from ctvae_torch.models.vgg import find_pretrained_weights
    path = find_pretrained_weights()
    if path is not None:
        log(f"gaussian dfc_vae: VGG19-bn weights at {path}: no refusal "
            f"to check")
        return {"weights": path}
    cfg = {**cfg, "logging_params": {**cfg["logging_params"],
                                     "save_dir": logs}}
    t0 = time.perf_counter()
    try:
        run.train(cfg, device="cuda")
    except RuntimeError as e:
        if "allow_random_features" not in str(e):
            raise
        log(f"gaussian dfc_vae as written: run.train refused in "
            f"{time.perf_counter() - t0:.1f} s: {str(e)[:160]}...")
        return {"refused": True}
    raise AssertionError("dfc_vae.yaml as written trained on random VGG "
                         "features without allow_random_features")


def _two_stage(stage: int, gen: torch.Generator, dtype: str = "float32",
               device: str = "cuda"):
    """TwoStageVAE at configs/vae.yaml's widths (its model_params; the
    stage-2 MLPs' default [1024, 1024]) on ``device``, ``train_stage``
    ``stage``, at ``dtype``, initialised from ``gen``."""
    from ctvae_torch.models import TwoStageVAE, init_weights
    mp = dict(read_config(os.path.join(os.path.dirname(CONFIG), "vae.yaml"))[
        "model_params"])
    mp.pop("name")
    model = TwoStageVAE(**mp, dtype=dtype, train_stage=stage, device=device)
    init_weights(model, gen)
    return model.eval()


def _zoo_last(smi: str, root: str, tmp: str, cfgs: dict, batch: dict,
              batches: list) -> dict:
    """The last of the registry from its YAML (ZOO_LAST), on the CelebA
    stand-in under ``root`` as written but ``data_path``: dfc_vae.yaml as
    written refused (``_vgg_refusal``), then with allow_random_features;
    each config's first full-width step at B = 64 against the CPU
    (FactorVAE's two calls), its timed zoo steps (DFCVAE's VGG
    bit-unchanged) and its serving against the CPU; run.train of LAST_RUNS
    one epoch each on the first LAST_EPOCH_STEPS train batches (a subset
    root beside the stand-in: FactorVAE's checkpoint must hold two
    optimizer states, its scalars ``lr_2``) and their loaders' share
    (``_epoch_pace``); the graph vs eager steps of MSSIMVAE and DFCVAE;
    TwoStageVAE at configs/vae.yaml's widths, a ``train_stage`` 1 and a 2
    step against the CPU, and its serving (``sample``: two-stage). The
    caller counts the launches (path ``gaussian``: none). Returns the
    numbers."""
    from ctvae_torch import run
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    t_start = time.perf_counter()
    out = {"card": smi, "epochs": {}, "steps": {}, "serve": {}}
    sub = _celeba_subset(root, os.path.join(tmp, "celeba_last"),
                         LAST_EPOCH_STEPS * GAUSSIAN_BATCH,
                         LAST_VAL_BATCHES * GAUSSIAN_BATCH)
    logs = os.path.join(tmp, "logs_last")
    dfc = cfgs["dfc_vae"]
    out["vgg_refusal"] = _vgg_refusal(
        {**dfc, "data_params": {**dfc["data_params"], "data_path": sub}},
        os.path.join(tmp, "logs_refusal"))
    cfgs = {n: {**cfgs[n], "model_params": {
        **cfgs[n]["model_params"],
        **({"allow_random_features": True} if n == "dfc_vae" else {})}}
        for n in ZOO_LAST}
    out["first_step_vs_cpu"] = {
        n: _train_step_vs_cpu(n, cfgs[n], {"image": batch["image"]},
                              reruns=FACTORVAE_RERUNS if n == "factorvae"
                              else 0)
        for n in ZOO_LAST}
    for n in ZOO_LAST:
        out["steps"][n] = _zoo_step(n, cfgs[n], batch)
        model = build_model(cfgs[n]["model_params"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                SEED))
        out["serve"][n] = _gaussian_serve(model, f"gaussian {n}")
        del model
    for n in LAST_RUNS:
        cfg = {**cfgs[n], "data_params": {**cfgs[n]["data_params"],
                                          "data_path": sub},
               "logging_params": {**cfgs[n]["logging_params"],
                                  "save_dir": logs}}
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-VGG warning
            res = run.train(cfg, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_dir = _check_run(f"gaussian {n}", cfg, res, logs)
        out["epochs"][n] = _epoch_numbers(f"gaussian {n}", res, secs, None,
                                          _counts(), smi)
        if int(res["train_steps_base"]) != LAST_EPOCH_STEPS:
            raise AssertionError(f"{n}: {res['train_steps_base']} steps")
        if n == "factorvae":
            blob = torch.load(os.path.join(run_dir, "checkpoints", "last"),
                              map_location="cpu", weights_only=True)
            with open(os.path.join(run_dir, "scalars.jsonl")) as f:
                lr_2 = [json.loads(line)["lr_2"] for line in f
                        if "lr_2" in line]
            counts = [o["count"] for o in blob["optimizers"]]
            if len(blob["optimizers"]) != 2 or not lr_2 or \
                    counts != [LAST_EPOCH_STEPS] * 2 or \
                    blob["step"] != 2 * LAST_EPOCH_STEPS:
                raise AssertionError(f"factorvae: checkpoint step "
                                     f"{blob['step']}, optimizer counts "
                                     f"{counts}, lr_2 lines {lr_2}")
            log(f"gaussian factorvae: checkpoint with two optimizer states "
                f"(counts {counts}, step {blob['step']}); scalars.jsonl "
                f"lr_2 {lr_2}")
            out["epochs"][n]["lr_2"] = lr_2
        pdata = VAEDataset(**cfg["data_params"])
        pdata.setup()
        host_ms, copy_ms, _ = _loader_ms(pdata)
        model = build_model(cfg["model_params"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                SEED))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out["epochs"][n]["pace"] = _epoch_pace(
                f"gaussian {n}", model, _exp_params(cfg), pdata, host_ms,
                copy_ms, smi)
        del model
        torch.cuda.empty_cache()
    out["graph_max_diff"] = {n: _gaussian_graph(n, cfgs[n], batches)
                             for n in ("mssim_vae", "dfc_vae")}
    vae = cfgs.get("vae") or _gaussian_config("vae", root, logs)
    for stage in (1, 2):
        out["first_step_vs_cpu"][f"two_stage_{stage}"] = _train_step_vs_cpu(
            f"two_stage_{stage}", vae, {"image": batch["image"]},
            build=lambda gen, stage=stage: _two_stage(stage, gen))
    model = _two_stage(2, torch.Generator("cuda").manual_seed(SEED))
    out["serve"]["two_stage"] = _gaussian_serve(model, "gaussian two_stage")
    del model
    out["wall_s"] = time.perf_counter() - t_start
    log(f"gaussian last of the registry: {out['wall_s']:.1f} s")
    return out


def _epoch_watch(label: str, name: str):
    """A _NonfiniteWatch over the epoch of a config in DIVERGE_IN_EPOCHS
    (its steps then pay one host read each), else a context that watches
    nothing (as None)."""
    return (_NonfiniteWatch(label) if name in DIVERGE_IN_EPOCHS
            else contextlib.nullcontext())


def _epoch_numbers(label: str, out: dict, secs: float, watch, counts: dict,
                   smi: str) -> dict:
    """A ``run.train`` epoch's numbers, logged; its images/s dropped when
    the epoch turned non-finite (a step then runs on non-finite values)."""
    first = None if watch is None else watch.first
    rate = out["train_images_per_sec"] if first is None else None
    log(f"{label}: run.train of the YAML in {secs:.2f} s "
        f"({int(out['train_steps_base'])} steps of B={GAUSSIAN_BATCH}"
        f"{', each watched' if watch is not None else ''}); epoch images/s "
        + (f"{rate:.1f}" if first is None else
           f"not kept (non-finite from step {first}; "
           f"{out['train_images_per_sec']:.1f} read)")
        + f"; train loss {out['train_loss']:.6g}, val loss "
        f"{out['val_loss']:.6g}; launches {json.dumps(counts)} ({smi})")
    return {"images_per_sec": rate, "nonfinite_from_step": first,
            "watched": watch is not None, "train_loss": out["train_loss"],
            "val_loss": out["val_loss"],
            "steps": int(out["train_steps_base"]), "run_s": secs}


def phase_gaussian(smi: str, celeba_root: str) -> tuple:
    """VQVAE and the Gaussian zoo on the card from their YAML, at full
    width, on the CelebA stand-in under ``celeba_root``
    (``_celeba_standin``; ``dataset_name: Celeba`` as written, 178 x 218
    JPEGs to 64 x 64; phase "celeba" trains ``configs/vae.yaml`` and
    ``configs/vq_vae.yaml`` on it): ``run.train`` of
    ``configs/synthetic_vae.yaml`` as written (only its logs moved);
    every VQ search call of a VQVAE train
    step and of its eval step held against the plain version at K = 512
    and timed with it and ``cdist`` + ``argmin``; a warm and timed eager
    train steps of VanillaVAE, VQVAE and each ZOO_CONFIGS and ZOO_MORE
    model at B = 64, each profiled once; ``run.train`` of
    ``configs/lvae.yaml``, ``gammavae.yaml`` and ``cat_vae.yaml`` (one
    epoch each, checkpoints, grids); the serving entry points of
    VanillaVAE and each ZOO_MORE model against the CPU; the multi-step
    graph against eager steps for VanillaVAE, BetaVAE B, CategoricalVAE
    and GammaVAE; the loader's share of the lvae, gammavae and cat_vae
    epochs; the last of the registry
    (``_zoo_last``: MSSIMVAE, DFCVAE with its VGG refusal, FactorVAE's two
    optimizers, TwoStageVAE). Launch counters are reset
    before and read after VQVAE's steps (path ``gaussian_vq``) and the
    rest (path ``gaussian``, where no kernel may launch). Returns
    (gaussian launches, gaussian_vq launches, the VQ rows, the
    numbers)."""
    import tempfile
    from ctvae_torch import run
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.data.prefetch import to_device
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state

    start = time.perf_counter()
    numbers = {"card": smi, "epochs": {}, "steps": {}}
    gauss = {k: 0 for k in EXPECTED_TRAIN["base"]}

    def add(counts):
        for k, n in counts.items():
            gauss[k] += n

    with tempfile.TemporaryDirectory(prefix="ctvae_gaussian_") as tmp:
        root, logs = celeba_root, os.path.join(tmp, "logs")
        cfgs = {n: _gaussian_config(n, root, logs)
                for n in dict.fromkeys(ZOO_BASE + GAUSSIAN_RUNS + ZOO_CONFIGS
                                       + ZOO_MORE + ZOO_LAST)}
        vq_launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
        for name in GAUSSIAN_RUNS:
            cfg = cfgs[name]
            _reset_counts()
            t0 = time.perf_counter()
            with wall("gaussian.runs"), \
                    _epoch_watch(f"gaussian {name}", name) as watch:
                out = run.train(cfg, device="cuda")
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
            add(counts)
            _check_run(f"gaussian {name}", cfg, out, logs, watch=watch,
                       diverge_from=DIVERGE_IN_EPOCHS.get(name))
            numbers["epochs"][name] = _epoch_numbers(
                f"gaussian {name}", out, secs, watch, counts, smi)
        # synthetic_vae.yaml as written (its logs moved)
        syn = read_config(os.path.join(os.path.dirname(CONFIG),
                                       "synthetic_vae.yaml"))
        syn["logging_params"] = {**syn["logging_params"], "save_dir": logs}
        syn["logging_params"]["name"] = "synthetic_vae"
        _reset_counts()
        with wall("gaussian.runs"):
            out = run.train(syn, device="cuda")
        add(_counts())
        _check_run("gaussian synthetic_vae", syn, out, logs)
        numbers["epochs"]["synthetic_vae"] = {
            "images_per_sec": out["train_images_per_sec"],
            "val_loss": out["val_loss"]}

        data = VAEDataset(**cfgs["vae"]["data_params"])
        data.setup()
        batches, epoch = [], 0
        while len(batches) < 2 * SCAN_K:
            for b in data.train_dataloader(epoch):
                b.pop("mode")
                batches.append(to_device(b, "cuda"))
                if len(batches) == 2 * SCAN_K:
                    break
            epoch += 1
        batch = batches[0]

        # the loader's share of the new configs' epochs (phase "celeba"
        # paces vae's and vq_vae's)
        numbers["pace"] = {}
        for name in GAUSSIAN_RUNS:
            cfg = cfgs[name]
            with wall("gaussian.pace"):
                pdata = VAEDataset(**cfg["data_params"])
                pdata.setup()
                host_ms, copy_ms, _ = _loader_ms(pdata)
                model = build_model(cfg["model_params"], device="cuda",
                                    generator=torch.Generator("cuda")
                                    .manual_seed(SEED))
                numbers["pace"][name] = _epoch_pace(
                    f"gaussian {name}", model, _exp_params(cfg), pdata,
                    host_ms, copy_ms, smi)
                del model
                torch.cuda.empty_cache()

        # VQVAE's steps: each VQ call held against the plain version
        vcfg = cfgs["vq_vae"]
        model = build_model(vcfg["model_params"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                SEED))
        state = create_train_state(model, build_optimizers(
            vcfg["exp_params"], model, steps_per_epoch=100), seed=SEED)
        with wall("gaussian.vq_rows"):
            vq_rows = _vq_rows(state, batch)
        del model, state

        # a warm and timed eager steps per model: VQVAE's on the
        # gaussian_vq path, the others' on the gaussian path
        _reset_counts()
        with wall("gaussian.vs_cpu"):
            numbers["first_step_vs_cpu"] = {
                name: _train_step_vs_cpu(name, cfgs[name], {"image": batch[
                    "image"]}) for name in ZOO_MORE}
        add(_counts())
        for name in dict.fromkeys(ZOO_BASE + GAUSSIAN_RUNS + ZOO_CONFIGS
                                  + ZOO_MORE):
            _reset_counts()
            with wall("gaussian.steps"):
                numbers["steps"][name] = _zoo_step(name, cfgs[name], batch)
            counts = _counts()
            if name == "vq_vae":
                for k, n in counts.items():
                    vq_launches[k] += n
            else:
                add(counts)

        _reset_counts()
        numbers["serve"] = {}
        with wall("gaussian.serve"):
            for name in ("vae",) + ZOO_MORE:
                model = build_model(cfgs[name]["model_params"],
                                    device="cuda", generator=torch.Generator(
                                        "cuda").manual_seed(SEED))
                numbers["serve"][name] = _gaussian_serve(
                    model, f"gaussian {name}",
                    sample_overflows=name == "lvae")
                del model
        with wall("gaussian.graph"):
            numbers["graph_max_diff"] = {
                n: _gaussian_graph(n, cfgs[n], batches)
                for n in ("vae", "bbvae", "cat_vae", "gammavae")}
        add(_counts())
        _reset_counts()
        with wall("gaussian.last"):
            numbers["last"] = _zoo_last(smi, root, tmp, cfgs, batch,
                                        batches)
        add(_counts())
    if vq_launches["vq_l2_argmin"] == 0 or any(
            n for k, n in vq_launches.items() if k != "vq_l2_argmin") or \
            any(gauss.values()):
        raise AssertionError(f"gaussian: launches gaussian_vq "
                             f"{vq_launches}, gaussian {gauss}")
    log(f"launches on the gaussian_vq path: {json.dumps(vq_launches)}; on "
        f"the gaussian path: {json.dumps(gauss)}")
    numbers["wall_s"] = time.perf_counter() - start
    log(f"gaussian: phase {numbers['wall_s']:.1f} s")
    return gauss, vq_launches, vq_rows, numbers


# --- phase 13: the JPEG datasets ---------------------------------------------

CELEBA_N = 8_000           # stand-in images: 6,400 / 800 / 800 (epochs
                           # of 100 steps at B = 64; 16,000 until the
                           # smoke grew past 900 s)
#: configs trained one epoch through run.train on the stand-in, as written
#: but for data_path (vq_vae's VQ search makes the path celeba_vq)
CELEBA_RUNS = ("vae", "vq_vae", "cvae")
CELEBA_DECODE_B = 64       # files of the decode check, a batch of B = 64
CELEBA_DECODE_REPS = 11    # timed decodes of that batch
CELEBA_EPOCH_BATCHES = 8  # steps of each turn of the epoch
TCELEBA_ACTIONS = 20       # 2 x 10 variations of TCeleba: 21 GAT heads
TCELEBA_LIMIT = 384        # per mode: 24 TCeleba train batches of 16
TCELEBA_VAL_LIMIT = 64     # per mode: 4 validation batches of 16
CVAE_SERVE_ATOL = 1e-5     # ConditionalVAE's requests, card vs CPU
TRANSFORM_ATOL = 1e-6      # the transform's products on the card vs CPU
# the card's decode (pixel levels of 255): of the committed libjpeg
# reference's JPEGs against libjpeg's pixels, and of the stand-in's
# quality-80 JPEGs against the arrays they were rendered from (libjpeg's
# encode and decode of the first 64: max 106, mean 4.487)
DECODE_REF_MAX, DECODE_REF_MEAN = 64, 2.0
DECODE_Q80_MAX, DECODE_Q80_MEAN = 160, 6.0


def _celeba_standin(root: str, smi: str, n: int = CELEBA_N) -> dict:
    """The port's JPEG codec built and probed, then the CelebA stand-in
    under ``root``: ``n`` images rendered and encoded at quality 80
    (``ensure_celeba_standin``), a split in torchvision's proportions
    over them and an attribute file (``label_celeba_standin``: the
    script's split puts every image of a stand-in this small in train,
    and it writes no attributes), and ``variation_attrs_10.txt``
    (``generate_celeba``). Returns the seconds and sizes."""
    from ctvae_torch import native
    from ctvae_torch.data.standins import (ensure_celeba_standin,
                                           label_celeba_standin)
    from ctvae_torch.data.variations import generate_celeba
    t0 = time.perf_counter()
    codec = native.codec()
    out = {"codec": codec.version, "codec_build_s": codec.build_s,
           "codec_load_s": time.perf_counter() - t0,
           "nproc": len(os.sched_getaffinity(0))}
    log(f"celeba probe: JPEG codec {codec.name}, {codec.version}, built in "
        f"{codec.build_s:.2f} s (loaded in {out['codec_load_s']:.2f} s); "
        f"{out['nproc']} host cores ({smi})")
    t0 = time.perf_counter()
    ensure_celeba_standin(root, n)
    out["write_s"] = time.perf_counter() - t0
    out["split"] = label_celeba_standin(root, n)
    t0 = time.perf_counter()
    path = generate_celeba(root)
    out["variations_s"] = time.perf_counter() - t0
    with open(path) as f:
        out["transitions"] = sum(1 for _ in f) - 1
    folder = os.path.join(root, "celeba", "img_align_celeba")
    out["jpeg_mb"] = sum(os.path.getsize(os.path.join(folder, n))
                         for n in os.listdir(folder)) / 1e6
    log(f"celeba stand-in: {n} images of 178 x 218 rendered and "
        f"encoded at quality 80 in {out['write_s']:.2f} s "
        f"({out['jpeg_mb']:.1f} MB of JPEG); the smoke's own split "
        f"{json.dumps(out['split'])} (torchvision's proportions; the "
        f"stand-in writer's split puts all {n} in train) and "
        f"attribute file; variation_attrs_10.txt: {out['transitions']} "
        f"transitions in {out['variations_s']:.2f} s ({smi})")
    return out


def _card_transform(raw, crop: int, size: int):
    """``StandardTransform(size, crop).batch`` of a uint8 batch with its
    two products on the card (the same matrices)."""
    from ctvae_torch.data.transforms import axis_matrix
    n, H, W, C = raw.shape
    mh = torch.from_numpy(axis_matrix(H, crop, size).copy()).cuda()
    mw = torch.from_numpy(axis_matrix(W, crop, size).copy()).cuda()
    x = torch.from_numpy(raw).cuda().float().div_(
        torch.full((), 255.0, device="cuda"))
    rows = torch.matmul(mh, x.reshape(n, H, W * C))
    out = torch.matmul(mw, rows.reshape(n * size, W, C))
    return out.reshape(n, size, size, C).cpu().numpy()


def _decode_check(root: str, smi: str) -> dict:
    """(c): the codec's decode of the stand-in's first CELEBA_DECODE_B
    files against the arrays they were rendered from (the error of
    quality-80 JPEG) and of the committed libjpeg reference's JPEGs
    against libjpeg's pixels; the decode's and the transform's host ms
    on that batch; the transform's products on the card against the
    CPU's."""
    import numpy as np

    from ctvae_torch import native
    from ctvae_torch.data.standins import render_celeba_images
    from ctvae_torch.data.transforms import StandardTransform
    codec = native.codec()
    idx = range(1, CELEBA_DECODE_B + 1)
    paths = [os.path.join(root, "celeba", "img_align_celeba", f"{i:06d}.jpg")
             for i in idx]
    raw = codec.decode_batch(paths)
    diff = np.abs(raw.astype(np.int16)
                  - render_celeba_images(idx).astype(np.int16))
    out = {"codec": codec.version, "vs_rendered_max": int(diff.max()),
           "vs_rendered_mean": float(diff.mean())}
    ref = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "torch_jpeg_reference.npz")
    with np.load(ref) as z, tempfile.TemporaryDirectory() as tmp:
        for key in sorted(k for k in z.files if k.startswith("jpeg_")):
            name = key[len("jpeg_"):]
            path = os.path.join(tmp, f"{name}.jpg")
            with open(path, "wb") as f:
                f.write(z[key].tobytes())
            d = np.abs(codec.decode(path).astype(np.int16)
                       - z[f"decoded_{name}"].astype(np.int16))
            out[f"vs_libjpeg_{name}"] = {"max": int(d.max()),
                                         "mean": float(d.mean())}
    secs = []
    for _ in range(CELEBA_DECODE_REPS):
        t0 = time.perf_counter()
        codec.decode_batch(paths)
        secs.append(1e3 * (time.perf_counter() - t0))
    out["decode_ms"] = statistics.median(secs)
    transform = StandardTransform(64, crop=148)
    secs = []
    for _ in range(CELEBA_DECODE_REPS):
        t0 = time.perf_counter()
        cpu = transform.batch(raw)
        secs.append(1e3 * (time.perf_counter() - t0))
    out["transform_ms"] = statistics.median(secs)
    out["transform_card_vs_cpu"] = float(np.abs(
        _card_transform(raw, 148, 64) - cpu).max())
    log(f"celeba decode check ({codec.version}), B={CELEBA_DECODE_B} files "
        f"of 178 x 218: against the rendered arrays max abs err "
        f"{out['vs_rendered_max']} levels, mean {out['vs_rendered_mean']:.4f} "
        f"(quality 80); the libjpeg reference's JPEGs against libjpeg's "
        f"pixels {json.dumps({k: v for k, v in out.items() if k.startswith('vs_libjpeg')})}; "
        f"decode {out['decode_ms']:.3f} ms, transform to 64 x 64 "
        f"{out['transform_ms']:.3f} ms on the host (medians of "
        f"{CELEBA_DECODE_REPS}); the transform's products on the card "
        f"against the CPU: max abs err {out['transform_card_vs_cpu']:.3g} "
        f"(tolerance {TRANSFORM_ATOL}) ({smi})")
    refs = [v for k, v in out.items() if k.startswith("vs_libjpeg")]
    if not (len(refs) == 3 and all(
            r["max"] <= DECODE_REF_MAX and r["mean"] <= DECODE_REF_MEAN
            for r in refs) and out["vs_rendered_max"] <= DECODE_Q80_MAX
            and out["vs_rendered_mean"] <= DECODE_Q80_MEAN
            and out["transform_card_vs_cpu"] <= TRANSFORM_ATOL):
        raise AssertionError(f"celeba decode check: {out}")
    return out


#: a photo's size for the PNG decode (H, W): OxfordPets' typical image
PNG_PHOTO = (375, 500)
PNG_DECODES = 3


def _png_decode_check() -> dict:
    """``read_png`` on a photo-sized RGB PNG whose every row is Paeth
    filtered (the filter encoders choose most for photos): the pixels
    back exactly, and the host ms of a decode (median of PNG_DECODES)."""
    import zlib
    from ctvae_torch.utils.images import _png_chunk, read_png
    h, w = PNG_PHOTO
    rng = torch.Generator().manual_seed(SEED)
    img = torch.randint(0, 16, (h, w, 3), generator=rng).cumsum(1)
    img = (img + torch.arange(h)[:, None, None]).remainder(256).to(
        torch.int16)
    pad = torch.nn.functional.pad(img, (0, 0, 1, 0, 1, 0))
    a, b, c = pad[1:, :-1], pad[:-1, 1:], pad[:-1, :-1]
    p = a + b - c
    pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - c).abs()
    pred = torch.where((pa <= pb) & (pa <= pc), a,
                       torch.where(pb <= pc, b, c))
    rows = torch.cat([torch.full((h, 1), 4, dtype=torch.int16),
                      ((img - pred) & 0xFF).reshape(h, -1)], 1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(
                rows.to(torch.uint8).numpy().tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with tempfile.TemporaryDirectory(prefix="ctvae_png_") as tmp:
        path = os.path.join(tmp, "paeth.png")
        with open(path, "wb") as f:
            f.write(data)
        times = []
        for _ in range(PNG_DECODES):
            t0 = time.perf_counter()
            out = read_png(path)
            times.append(1e3 * (time.perf_counter() - t0))
    if not torch.equal(torch.from_numpy(out), img.to(torch.uint8)):
        raise AssertionError("read_png of a Paeth-filtered PNG differs from "
                             "its pixels")
    ms = statistics.median(times)
    log(f"read_png: {w}x{h} RGB, every row Paeth, {ms:.3f} ms a decode on "
        f"the host (median of {PNG_DECODES}); pixels exact")
    return {"shape": [h, w, 3], "ms": ms, "ms_each": times}


def _epoch_pace(label: str, model, exp: dict, data, host_ms: float,
                copy_ms: float, smi: str) -> dict:
    """The first CELEBA_EPOCH_BATCHES steps of an epoch of ``data`` on
    ``model`` in turns (PACE_TURNS): ms per step with the batches held and
    assembled inline, and the loader's share of the inline epoch."""
    n = min(CELEBA_EPOCH_BATCHES, data.steps_per_epoch())
    ways = {how: _EpochOf(data, n, how) for how in ("held", "inline")}
    turns = {how: [] for how in ways}
    for how in PACE_TURNS:
        turns[how].append(_epoch_ms(model, exp, ways[how], GAUSSIAN_BATCH))
    ms = {how: statistics.mean(v) for how, v in turns.items()}
    share = (ms["inline"] - ms["held"]) / ms["inline"]
    log(f"{label} B={GAUSSIAN_BATCH}: loader {host_ms:.3f} ms per batch on "
        f"the host (get_batch: decode and transform; median of "
        f"{LOADER_BATCHES}), pinned copy {copy_ms:.3f} ms; {n} steps in "
        f"turns, ms per step: batches held {ms['held']:.3f}, inline "
        f"{ms['inline']:.3f}: the loader takes {100 * share:.1f}% of the "
        f"inline epoch ({smi})")
    return {"loader_host_ms_per_batch": host_ms, "copy_ms_per_batch": copy_ms,
            "epoch_batches": n, "epoch_ms_per_step": turns,
            "loader_share": share}


def phase_celeba(smi: str, root: str) -> tuple:
    """The JPEG datasets through the port's entry points, on the CelebA
    stand-in under ``root`` (``_celeba_standin``): (c) the decode check
    (``_decode_check``) and the PNG decode (``_png_decode_check``); (d) ``run.train`` of ``configs/vae.yaml``,
    ``vq_vae.yaml`` and ``cvae.yaml`` with ``dataset_name: Celeba`` as
    written (one epoch each: checkpoints, grids, ConditionalVAE's Samples
    decoded beside the batch's labels), then per config the loader's and
    the copy's host ms per batch and the epoch's first
    CELEBA_EPOCH_BATCHES steps in turns with batches held and inline (the
    loader's share), and every VQ search call of a VQVAE train and eval
    step at K = 512 against the plain version; (e) ``configs/
    ct_mcq_vae.yaml`` at full width on TCeleba (``action_dim: 20``: 21
    GAT heads, the causal batch A*B = 320), one epoch cut by ``limit``,
    then every kernel call of each mode's step held against its plain
    version and timed with it and its bound; (f) ConditionalVAE's
    serving entry points with labels against the CPU. Launch counters are
    reset before and read after the VQVAE run (path ``celeba_vq``), the
    VanillaVAE and ConditionalVAE runs (path ``celeba``, no kernel) and
    the CT run (path ``tceleba``, every kernel). Returns (celeba
    launches, celeba_vq launches, tceleba launches, the K = 512 VQ rows,
    the tceleba rows by kernel, the numbers)."""
    from ctvae_torch import run
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)

    start = time.perf_counter()
    numbers = {"card": smi, "decode": walled("celeba.decode", _decode_check,
                                             root, smi),
               "png_decode": walled("celeba.png", _png_decode_check),
               "epochs": {}, "pace": {}}
    celeba = {k: 0 for k in EXPECTED_TRAIN["base"]}
    vq_launches = None
    with tempfile.TemporaryDirectory(prefix="ctvae_celeba_") as tmp:
        logs = os.path.join(tmp, "logs")
        cfgs = {n: _gaussian_config(n, root, logs) for n in CELEBA_RUNS}
        for name, cfg in cfgs.items():
            _reset_counts()
            t0 = time.perf_counter()
            with wall("celeba.runs"), \
                    _epoch_watch(f"celeba {name}", name) as watch:
                out = run.train(cfg, device="cuda")
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
            if name == "vq_vae":
                vq_launches = counts
            else:
                for k, n in counts.items():
                    celeba[k] += n
            _check_run(f"celeba {name}", cfg, out, logs,
                       samples=name != "vq_vae", watch=watch,
                       diverge_from=DIVERGE_IN_EPOCHS.get(name))
            numbers["epochs"][name] = _epoch_numbers(
                f"celeba {name} (dataset_name Celeba)", out, secs, watch,
                counts, smi)

        # the loader, the copy, the loader's share of the epoch; VQVAE's
        # VQ calls at K = 512
        vq_rows = None
        t_part = time.perf_counter()
        for name, cfg in cfgs.items():
            data = VAEDataset(**cfg["data_params"])
            data.setup()
            host_ms, copy_ms, batches = _loader_ms(data)
            exp = cfg["exp_params"]
            model = build_model(cfg["model_params"], device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(SEED))
            if name == "vq_vae":
                state = create_train_state(model, build_optimizers(
                    exp, model, steps_per_epoch=100), seed=SEED)
                vq_rows = _vq_rows(state, batches["base"])
                del state
            numbers["pace"][name] = _epoch_pace(f"celeba {name}", model,
                                                exp, data, host_ms, copy_ms,
                                                smi)
            del model, batches
            torch.cuda.empty_cache()

        WALL["celeba.pace"] = round(time.perf_counter() - t_part, 1)

        # (e) the CT model on TCeleba: 20 actions, 21 GAT heads
        t_part = time.perf_counter()
        ct = read_config(CONFIG)
        ct["model_params"] = {**ct["model_params"],
                              "action_dim": TCELEBA_ACTIONS}
        ct["data_params"] = {**ct["data_params"], "dataset_name": "TCeleba",
                             "data_path": root, "limit": TCELEBA_LIMIT,
                             "val_limit": TCELEBA_VAL_LIMIT}
        ct["trainer_params"] = {**ct["trainer_params"], "max_epochs": 1}
        ct["logging_params"] = {**ct["logging_params"], "save_dir": logs,
                                "name": "CTMCQVAE_TCeleba"}
        B = ct["data_params"]["train_batch_size"]
        _reset_counts()
        t0 = time.perf_counter()
        out = run.train(ct, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tceleba = _counts()
        _check_run("celeba tceleba", ct, out, logs)
        steps = {m: int(out.get(f"train_steps_{m}", 0))
                 for m in EXPECTED_TRAIN}
        if set(steps.values()) != {TCELEBA_LIMIT // B} or not all(
                tceleba.values()):
            raise AssertionError(f"tceleba: mode mix {steps}, launches "
                                 f"{tceleba}")
        numbers["epochs"]["tceleba_ct"] = {
            "images_per_sec": out["train_images_per_sec"],
            "train_loss": out["train_loss"], "val_loss": out["val_loss"],
            "steps": steps, "run_s": secs}
        log(f"celeba tceleba: run.train of configs/ct_mcq_vae.yaml with "
            f"dataset_name TCeleba, action_dim {TCELEBA_ACTIONS} "
            f"({TCELEBA_ACTIONS + 1} GAT heads, causal A*B = "
            f"{TCELEBA_ACTIONS * B}), limit {TCELEBA_LIMIT}: {secs:.2f} s, "
            f"steps {json.dumps(steps)}, epoch images/s "
            f"{out['train_images_per_sec']:.1f}, train loss "
            f"{out['train_loss']:.6g}, val loss {out['val_loss']:.6g}; "
            f"launches {json.dumps(tceleba)} ({smi})")
        data = VAEDataset(**ct["data_params"])
        data.setup()
        host_ms, copy_ms, batches = _loader_ms(data)
        model = build_model(ct["model_params"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                SEED))
        state = create_train_state(model, build_optimizers(
            ct["exp_params"], model, steps_per_epoch=100), seed=SEED)
        rows, step_ms = {}, {}
        for mode in EXPECTED_TRAIN:
            step, batch = make_train_step(mode), batches[mode]
            secs = []
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(step(state, batch)["loss"])
                secs.append(1e3 * (time.perf_counter() - t0))
                if not math.isfinite(loss):
                    raise AssertionError(f"tceleba {mode}: loss {loss}")
            step_ms[mode] = statistics.median(secs[1:])

            def run_step(mode=mode):
                return make_train_step(mode)(state, batches[mode])
            vq = _vq_on_path(run_step)
            found = _kernels_on_step(f"tceleba {mode}", run_step)
            plain = _plain_ms_on_step(run_step)
            for k, r in _search_rows(
                    "tceleba", mode, ct["model_params"]["num_embeddings"],
                    vq, found, plain).items():
                rows.setdefault(k, []).extend(r)
        numbers["tceleba_pace"] = {"loader_host_ms_per_batch": host_ms,
                                   "copy_ms_per_batch": copy_ms,
                                   "train_ms_per_step": step_ms}
        log(f"tceleba B={B}: loader {host_ms:.3f} ms per batch on the host "
            f"(x and y decoded for the transition modes), pinned copy "
            f"{copy_ms:.3f} ms; eager train step "
            f"{json.dumps({m: round(v, 3) for m, v in step_ms.items()})} ms "
            f"(median of {TRAIN_STEPS - 1} after a warm-up) ({smi})")
        del model, state, batches
        torch.cuda.empty_cache()

        WALL["celeba.tceleba"] = round(time.perf_counter() - t_part, 1)

        # (f) ConditionalVAE's serving with labels, card against the CPU
        _reset_counts()
        model = build_model(cfgs["cvae"]["model_params"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                SEED))
        numbers["serve_cvae"] = _gaussian_serve(model, "celeba cvae",
                                                CVAE_SERVE_ATOL)
        for k, n in _counts().items():
            celeba[k] += n
        del model
    if vq_launches is None or vq_launches["vq_l2_argmin"] == 0 or any(
            n for k, n in vq_launches.items() if k != "vq_l2_argmin") or \
            any(celeba.values()):
        raise AssertionError(f"celeba: launches celeba_vq {vq_launches}, "
                             f"celeba {celeba}")
    log(f"launches on the celeba_vq path: {json.dumps(vq_launches)}; on the "
        f"celeba path: {json.dumps(celeba)}; on the tceleba path: "
        f"{json.dumps(tceleba)}")
    numbers["wall_s"] = time.perf_counter() - start
    log(f"celeba: phase {numbers['wall_s']:.1f} s")
    return celeba, vq_launches, tceleba, vq_rows, rows, numbers


def _search_summary(rows: list) -> dict:
    """A kernel's rows of the search phase, by shape (the kernels line
    stays short: 4 significant digits): the number of calls and, over
    them, the median ms, bound, plain ms (and ``cdist`` + ``argmin``) and
    the largest ms."""
    by_shape = {}
    for r in rows:
        key = "x".join(str(d) for d in r["shape"]) + "".join(
            f" {t}={r[t]}" for t in ("K", "F") if t in r) + (
            f" {r['call']}" if "call" in r else "")
        by_shape.setdefault(key, []).append(r)
    out = {}
    for key, rs in sorted(by_shape.items()):
        out[key] = {"calls": len(rs), "bound_by": rs[0]["bound_by"],
                    "max_ms": float(f"{max(r['ms'] for r in rs):.4g}")}
        for k in ("ms", "bound_ms", "plain_ms", "library_ms"):
            if k in rs[0]:
                out[key][k] = float(
                    f"{statistics.median(r[k] for r in rs):.4g}")
    return out


# --- phase "export": the serving artifacts ---------------------------------

EXPORT_B = 16              # the headline's example batch (symbolic b)
EXPORT_B_OTHER = 5         # another batch the same files serve
EXPORT_CPU_B = 2           # the same files moved to the CPU
EXPORT_ZOO_B = 64          # the zoo configs' batch
EXPORT_REQUESTS = 11       # timed requests per entry point; the first warms
EXPORT_RTOL, EXPORT_ATOL = 1e-4, 1e-5   # artifact vs live (the same ops)
#: the dtypes each case is exported at: float32 (the path "export") and the
#: JAX bench's bfloat16 (the path "export_bf16")
EXPORT_DTYPES = ("float32", "bfloat16")
#: label -> (config, entry points) of the artifacts the phase exports
EXPORT_CASES = {
    "ct_mcq_vae": ("ct_mcq_vae.yaml", ("reconstruct", "encode", "sample",
                                        "apply_action", "classify_action")),
    "vq_vae": ("vq_vae.yaml", ("reconstruct", "encode")),
    "vae": ("vae.yaml", ("reconstruct", "encode", "sample")),
}
_BWD = ("pairwise_bwd", "gat_bwd", "gat_logits_bwd")

# run in a fresh process: loads each artifact with ctvae_torch.serving.
# export alone (no model code; each file read once), serves the saved
# requests on the card, and the B = 2 ones on the card and through the
# programs moved to the CPU
EXPORT_SERVER = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False   # full float32, as here
torch.backends.cudnn.allow_tf32 = False
from ctvae_torch.ops import launch_counts
from ctvae_torch.serving.export import load_artifact_on
requests, outputs = sys.argv[1:]
out = {}
for label, case in torch.load(requests).items():
    (card, cpu), manifest = load_artifact_on(case["dir"], [None, "cpu"])
    assert all(f["device"].startswith("cuda")
               for f in manifest["functions"].values()), manifest
    out[label] = {
        name: {"card": [card[name](*a).cpu() for a in calls],
               "small": card[name](*(a.cuda() for a in case["cpu"][name])
                                   ).cpu(),
               "cpu": cpu[name](*case["cpu"][name])}
        for name, calls in case["card"].items()}
torch.cuda.synchronize()
torch.save(out, outputs)
print(json.dumps({"models_imported": "ctvae_torch.models" in sys.modules,
                  "launches": launch_counts()}))
"""


def _export_requests(names, img: int, A: int, B: int, seed: int,
                     device: str) -> dict:
    """{entry point: its arguments at batch B}: its own key, images in
    [0, 1] and one-hot actions of A from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    x, y = (torch.rand(B, img, img, 3, generator=gen).to(device)
            for _ in range(2))
    a = torch.nn.functional.one_hot(torch.randint(0, A, (B,), generator=gen),
                                    A).float().to(device)
    arrays = {"reconstruct": (x,), "encode": (x,), "sample": (),
              "apply_action": (x, y, a), "classify_action": (x, y)}
    return {n: (torch.tensor(100 * seed + k, device=device), *arrays[n])
            for k, n in enumerate(names)}


def _launched(fn, *args):
    """(``fn(*args)`` synchronised, the kernel launches it made, the
    host ms it took); the counters are put back as they were."""
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    after = _counts()
    from ctvae_torch.ops import set_launch_counts
    set_launch_counts(before)
    return out, {k: after[k] - before[k] for k in after}, ms


def _held(label: str, got, want, rtol: float, atol: float) -> float:
    """Max |got - want|, raising where it is above atol + rtol |want|, the
    shapes differ or ``got`` is not finite."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or non-finite")
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{label}: |artifact - reference| up to "
                             f"{float(err.max())}")
    return float(err.max())


def _export_held(label: str, name: str, got, want, dtype: str,
                 cpu: bool) -> float:
    """An artifact's output against a reference at the case's dtype:
    against the live port on the card (``cpu`` False) at float32 within
    rtol 1e-4 / atol 1e-5, at bfloat16 within ``export_model.BF16_ULPS``
    bfloat16 ulps of the output's scale (the same operations in the same
    order: ``export_model.verify``'s bound); the files moved to the CPU
    against the card's output at float32 within ``SERVE_ATOL``, at
    bfloat16 by ``_bf16_card_cpu``'s rule (card and CPU round bfloat16 in
    other places and can flip a decision at a near-tie). Returns max
    |got - want|."""
    from ctvae_torch.export_model import BF16_ULPS
    what = f"export {label} {name}"
    if dtype == "float32":
        return _held(what, got, want, *((0.0, SERVE_ATOL) if cpu
                                        else (EXPORT_RTOL, EXPORT_ATOL)))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    got, want = got.float().cpu(), want.float().cpu()
    if cpu:
        ok, m = _bf16_card_cpu(name, want, got)
    else:
        scale = max(1.0, float(want.abs().max()))
        m = {"max_abs_err": float((got - want).abs().max())}
        ok = m["max_abs_err"] <= BF16_ULPS * BF16_ULP * scale
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {m}")
    return m["max_abs_err"]


def phase_export(smi: str) -> tuple:
    """The serving artifacts (``ctvae_torch/serving/export.py``) at full
    width, at float32 and again at ``dtype: bfloat16`` (``EXPORT_DTYPES``):
    ``configs/ct_mcq_vae.yaml`` as written (random weights, seed 0)
    exported on the card through ``export_model``'s functions, its five
    entry points with a symbolic batch at B = 16; then ``vq_vae.yaml``
    (the VQ search at K = 512 inside the program) and ``vae.yaml`` (no
    kernel) at B = 64, ``reconstruct`` / ``encode`` (/ ``sample``). Each
    artifact is saved to a temporary directory and loaded by one
    subprocess that imports no model code, which serves it on the card at
    B and at B = 5 (CT) or B - 1 (zoo), against the live port on the same
    keys (``KeyedDraws`` in both), and at B = 2 through the same files
    moved to the CPU, against the card's output (``_export_held``: the
    bounds of each dtype). Then, in this process, each request of the
    artifact's program (the exported program the files hold, as the
    subprocess served it) and of the live eager entry point in turns
    (medians of EXPORT_REQUESTS - 1 after a warm-up; the artifact's
    launches per request equal to the live port's), and every kernel call
    of one ``apply_action`` and one ``classify_action`` request of the
    bfloat16 CT artifact against its plain version at bfloat16
    (``_bf16_kernels_on_step``). The paths ``export`` and ``export_bf16``
    count the artifacts' launches in this process: the four forward
    kernels, no backward one. Returns (the two paths' launches, the
    numbers)."""
    from ctvae_torch import export_model
    from ctvae_torch.models import build_model
    from ctvae_torch.serving.export import (MANIFEST_NAME, model_manifest,
                                            save_artifact)
    start = time.perf_counter()
    numbers, cases, live_entries, programs = {"card": smi}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="ctvae_export_") as tmp:
        for (label, (cfg, names)), dtype in itertools.product(
                EXPORT_CASES.items(), EXPORT_DTYPES):
            path = os.path.join(os.path.dirname(CONFIG), cfg)
            params = {**read_section(path, "model_params"), "dtype": dtype}
            if dtype != "float32":
                label = f"{label}_{dtype}"
            model = build_model(params, device="cuda",
                                generator=torch.Generator(
                                    "cuda").manual_seed(SEED))
            ct = cfg == "ct_mcq_vae.yaml"
            B = EXPORT_B if ct else EXPORT_ZOO_B
            other = EXPORT_B_OTHER if ct else B - 1
            # the config's images (data_params.patch_size) and actions
            shape = (read_section(path, "data_params")["patch_size"],
                     params.get("action_dim", 1))
            with wall("export.export"):
                exported, entries, seconds = \
                    export_model.export_entry_points(
                        model, _export_requests(names, *shape, B, 1, "cuda"),
                        names, poly_batch=True, num_samples=B,
                        log=lambda m, label=label: log(
                            f"export {label}: {m}"))
            cases[label] = {
                "dir": save_artifact(os.path.join(tmp, label), exported,
                                     {**model_manifest(model),
                                      "config": cfg}),
                "dtype": dtype,
                "card": {n: [_export_requests(names, *shape, b, s,
                                              "cuda")[n]
                             for b, s in ((B, 2), (other, 3))]
                         for n in names},
                "cpu": _export_requests(names, *shape, EXPORT_CPU_B, 4,
                                        "cpu")}
            live_entries[label], programs[label] = entries, exported
            numbers[label] = {"export_s": seconds, "batch": B,
                              "other_batch": other, "dtype": dtype}
        requests, outputs = (os.path.join(tmp, f) for f in ("requests.pt",
                                                            "outputs.pt"))
        torch.save(cases, requests)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_SERVER, requests, outputs],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.dirname(
                os.path.abspath(__file__))})
        if proc.returncode != 0:
            raise AssertionError(f"export server failed:\n{proc.stderr}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        numbers["server_s"] = time.perf_counter() - t0
        WALL["export.server"] = round(numbers["server_s"], 1)
        log(f"export server (no model code): {numbers['server_s']:.1f} s, "
            f"launches {json.dumps(report['launches'])}")
        if report["models_imported"] or any(
                (report["launches"][k] == 0) != (k in _BWD)
                for k in report["launches"]):
            raise AssertionError(f"export server: {report}")
        served = torch.load(outputs)
        t_part = time.perf_counter()
        _zero = {k: 0 for k in _counts()}
        counts = {d: dict(_zero) for d in EXPORT_DTYPES}
        for label, case in cases.items():
            entries, dtype = live_entries[label], case["dtype"]
            with open(os.path.join(case["dir"], MANIFEST_NAME)) as f:
                manifest = json.load(f)
            fns = {n: torch.inference_mode()(p.module())
                   for n, p in programs[label].items()}
            if manifest["dtype"] != dtype:
                raise AssertionError(f"export {label}: manifest {manifest}")
            numbers[label]["in_specs"] = {
                n: manifest["functions"][n]["in_specs"] for n in fns}
            numbers[label]["out_specs"] = {
                n: manifest["functions"][n]["out_specs"] for n in fns}
            errs, times, bits = {}, {}, {}
            mine = dict(_zero)      # this artifact's launches
            for name, entry in entries.items():
                out = served[label][name]

                def live(*args, entry=entry):
                    with torch.inference_mode():
                        return entry(*args)
                for args, got in zip(case["card"][name], out["card"]):
                    b = args[1].shape[0] if len(args) > 1 else \
                        f"key {int(args[0])}"
                    want = live(*args)
                    errs[f"{name}@{b}"] = _export_held(
                        label, f"{name} B={b}", got, want, dtype, False)
                    bits[f"{name}@{b}"] = torch.equal(got, want.cpu())
                errs[f"{name}@cpu"] = _export_held(
                    label, name, out["cpu"], out["small"], dtype, True)
                args = case["card"][name][0]
                samples = {"artifact": [], "live": []}
                for r in range(EXPORT_REQUESTS):
                    turn = (("artifact", fns[name]), ("live", live))
                    for kind, fn in (turn if r % 2 == 0 else turn[::-1]):
                        _, launched, ms = _launched(fn, *args)
                        samples[kind].append(ms)
                        if kind == "artifact":
                            _add_counts(counts[dtype], _zero, launched)
                            _add_counts(mine, _zero, launched)
                        if r == 0:
                            samples[f"{kind}_launches"] = launched
                if samples["artifact_launches"] != samples["live_launches"]:
                    raise AssertionError(
                        f"export {label} {name}: launches per request "
                        f"{samples['artifact_launches']} against the live "
                        f"port's {samples['live_launches']}")
                times[name] = {k: statistics.median(samples[k][1:])
                               for k in ("artifact", "live")}
                log(f"export {label} {name} B={numbers[label]['batch']}: "
                    f"artifact {times[name]['artifact']:.3f} ms, live "
                    f"{times[name]['live']:.3f} ms per request (medians of "
                    f"{EXPORT_REQUESTS - 1} in turns)")
            numbers[label]["max_abs_err"] = errs
            numbers[label]["bit_equal_to_live"] = bits
            numbers[label]["launches"] = mine
            numbers[label]["request_ms"] = times
            log(f"export {label}: max |artifact - reference| "
                f"{json.dumps(errs)}; bit-equal to the live port "
                f"{json.dumps(bits)}")
            if label == "ct_mcq_vae_bfloat16":
                numbers[label]["kernels"] = {
                    name: _bf16_kernels_on_step(
                        f"export {name} request",
                        lambda name=name: fns[name](*case["card"][name][0]),
                        timed=False)
                    for name in ("apply_action", "classify_action")}
        WALL["export.requests"] = round(time.perf_counter() - t_part, 1)
    for dtype, c in counts.items():
        if any((c[k] == 0) != (k in _BWD) for k in c):
            raise AssertionError(f"launches on the export path at {dtype} "
                                 f"{c}")
    numbers["wall_s"] = time.perf_counter() - start
    log(f"launches on the export path: {json.dumps(counts['float32'])}")
    log(f"launches on the export_bf16 path: "
        f"{json.dumps(counts['bfloat16'])}")
    log(f"export: phase {numbers['wall_s']:.1f} s")
    return counts["float32"], counts["bfloat16"], numbers


# --- phase 15: data parallelism ---------------------------------------------

DDP_STEPS = 16        # (a): steps of each mode, plain and data-parallel
DDP_RANK_STEPS = 8    # (b): steps of each mode on each of two ranks
DDP_ROUNDS = 3        # (a): timed rounds of DDP_TIMED steps in turns
DDP_TIMED = 4
DDP_TIMEOUT = 400     # (b) and (c): seconds for the two rank processes
DDP_RTOL = 1e-5       # (b), (e), (g): each step's losses against one process
DDP_ATOL = 1e-5       # (b): parameters after it, plus Adam's reach
                      # (_adam_reach)
#: (g): the losses that are not a mean of per-row terms, as written
CROSS_BATCH_YAMLS = ("wae_mmd_imq", "wae_mmd_rbf", "infovae", "betatc_vae",
                     "dip_vae", "swae", "mssim_vae", "joint_vae", "bbvae")
CROSS_BATCH_STEPS = 2
DDP_BF16_RANK_STEPS = 3   # (i): steps of each mode per sharding at bfloat16


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ddp_batches(seed: int, n: int, B: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [dict(zip(("image", "input_y", "action"),
                     _requests(gen, B, "cuda"))) for _ in range(n)]


def _ddp_state(group, fsdp: bool = False, params=None):
    """The headline model (``params``: its model_params, by default the
    config's) and the config's exp_params (``ct_layer`` trained), seeded
    as ``_train_setup``; a data-parallel state over ``group`` gets rank
    0's weights and generator, and with ``fsdp`` its parameters split
    over the group (``fully_shard`` at the default ``fsdp_min_size``)
    before the optimizers are built over the slices."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import fully_shard, put_replicated
    from ctvae_torch.training import build_optimizers, create_train_state
    model = build_model(params or MODEL_PARAMS, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(model, [], seed=SEED, group=group)
    put_replicated(model, group, state.generator)
    if fsdp:
        state.fsdp = fully_shard(model, group)
    state.optimizers = build_optimizers(EXP_PARAMS, model,
                                        steps_per_epoch=100, fsdp=state.fsdp)
    return state


def _add_counts(total: dict, c0: dict, c1: dict) -> None:
    for k in total:
        total[k] += c1[k] - c0[k]


def _ddp_world1(launches: dict, fsdp_launches: dict) -> dict:
    """(a) A process group of one rank over NCCL: per mode DDP_STEPS
    data-parallel steps against as many plain steps from an equal state
    on the same batches (every parameter, Adam moment, the generator and
    the last metrics bit for bit: a sum over one rank divided by 1 is
    exact), each DP step's launches as the plain step's; then both timed
    in turns, the gradient bucket's bytes and the all-reduce's ms, and
    ``make_multi_train_step(mode, SCAN_K)`` on a data-parallel state (the
    reductions inside the captured graph) against eager DP steps within
    SCAN_RTOL. (d) The same under ``sharding: fsdp`` (path "fsdp"): a
    data size of 1 splits nothing, as in JAX; DDP_STEPS FSDP steps per
    mode bit-equal to the plain ones with the plain step's launches, and
    a captured FSDP multi-step against the eager DP steps."""
    from ctvae_torch.parallel import all_reduce_grads, destroy, \
        init_distributed
    from ctvae_torch.training import make_multi_train_step, make_train_step
    from ctvae_torch.training.state import WARMUP_STEPS
    group = init_distributed(device=torch.device("cuda", 0),
                             init_method=f"tcp://127.0.0.1:{_free_port()}",
                             rank=0, world_size=1)
    numbers: dict = {"backend": torch.distributed.get_backend(group)}
    try:
        plain, dp = _ddp_state(None), _ddp_state(group)
        fs = _ddp_state(group, fsdp=True)
        if fs.fsdp.shards:
            raise AssertionError(f"fsdp world 1 split "
                                 f"{sorted(fs.fsdp.shards)[:4]}")
        for mode, expected in EXPECTED_TRAIN.items():
            step = make_train_step(mode)
            batches = _ddp_batches(SEED + 11, DDP_STEPS, BATCH)
            for b in batches:
                want = step(plain, b)
            for state, counts, label in ((dp, launches, "ddp"),
                                         (fs, fsdp_launches, "fsdp")):
                for b in batches:
                    c0 = _counts()
                    got = step(state, b)
                    c1 = _counts()
                    _add_counts(counts, c0, c1)
                    per = {k: c1[k] - c0[k] for k in c1}
                    if per != expected:
                        raise AssertionError(f"{label} world 1 {mode}: "
                                             f"launches per step {per}, "
                                             f"expected {expected}")
                a, b_ = _scan_tensors(plain), _scan_tensors(state)
                differ = [n for n in a if not torch.equal(a[n], b_[n])]
                differ += [f"metric {k}" for k in want
                           if not torch.equal(want[k], got[k])]
                if not torch.equal(plain.generator.get_state(),
                                   state.generator.get_state()):
                    differ.append("generator")
                log(f"{label} world 1 {mode}: {len(a)} parameters and Adam "
                    f"moments and {len(want)} metrics after {DDP_STEPS} "
                    f"steps, plain vs {label} over NCCL: {len(differ)} "
                    f"differ; loss {float(got['loss']):.6g}")
                if differ:
                    raise AssertionError(f"{label} world 1 {mode}: not "
                                         f"bit-equal: {differ[:8]}")
            # in turns; the FSDP state takes the same steps, so the three
            # states stay equal for the next mode's comparison
            secs = {"plain": [], "dp": [], "fsdp": []}
            states = {"plain": plain, "dp": dp, "fsdp": fs}
            for r in range(DDP_ROUNDS):
                for which in (("plain", "dp", "fsdp") if r % 2 == 0
                              else ("fsdp", "dp", "plain")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b in batches[:DDP_TIMED]:
                        step(states[which], b)
                    torch.cuda.synchronize()
                    secs[which].append(1e3 * (time.perf_counter() - t0)
                                       / DDP_TIMED)
            numbers[f"{mode}_ms"] = {w: statistics.median(t)
                                     for w, t in secs.items()}
            log(f"ddp world 1 {mode} B={BATCH}: plain "
                f"{numbers[f'{mode}_ms']['plain']:.3f} ms per step, "
                f"data-parallel {numbers[f'{mode}_ms']['dp']:.3f}, fsdp "
                f"{numbers[f'{mode}_ms']['fsdp']:.3f} (medians of "
                f"{DDP_ROUNDS} rounds of {DDP_TIMED} steps in turns; "
                + ", ".join(f"{w} {json.dumps([round(t, 3) for t in v])}"
                            for w, v in secs.items()) + ")")
        params = list(dp.model.parameters())
        numbers["bucket_bytes"] = all_reduce_grads(params, group)
        numbers["all_reduce_ms"] = time_ms(
            lambda: all_reduce_grads(params, group))
        log(f"ddp world 1: gradient bucket {numbers['bucket_bytes']} bytes "
            f"({sum(p.numel() for p in params)} parameters, f32), NCCL "
            f"all-reduce {numbers['all_reduce_ms']:.4f} ms (device time, "
            f"median of 21)")
        # the multi-step step over the group: its graph holds the
        # reductions (under FSDP also the gathers and the release)
        numbers["scan"], numbers["fsdp_scan"] = {}, {}
        for mode in EXPECTED_TRAIN:
            eager = _ddp_state(group)
            batches = _ddp_batches(SEED + 13, 2 * SCAN_K, BATCH)
            stacked = {k: torch.stack([b[k] for b in batches])
                       for k in batches[0]}
            step = make_train_step(mode)
            for b in batches:
                step(eager, b)
            for label, graph, counts in (
                    ("ddp", _ddp_state(group), launches),
                    ("fsdp", _ddp_state(group, fsdp=True), fsdp_launches)):
                multi = make_multi_train_step(mode, SCAN_K)
                for half in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K)):
                    multi(graph, {k: v[half] for k, v in stacked.items()})
                torch.cuda.synchronize()
                a, b_ = _scan_tensors(eager), _scan_tensors(graph)
                diffs = {n: float((a[n].float() - b_[n].float()).abs().max())
                         for n in a}
                bad = {n: d for n, d in diffs.items() if d > SCAN_RTOL * max(
                    float(a[n].float().abs().max()), 1e-30)}
                same_gen = torch.equal(eager.generator.get_state(),
                                       graph.generator.get_state())
                numbers["scan" if label == "ddp" else "fsdp_scan"][mode] = \
                    max(diffs.values())
                log(f"{label} world 1 scan {mode}: {len(diffs)} tensors "
                    f"after {2 * SCAN_K} steps, eager data-parallel vs "
                    f"{multi.replays} {label} graph replays (after "
                    f"{WARMUP_STEPS} warm-up steps): "
                    f"{sum(d == 0 for d in diffs.values())} bit-equal, "
                    f"largest difference {max(diffs.values()):.3g}; "
                    f"generator equal {same_gen}")
                if bad or not same_gen or \
                        multi.replays != 2 * SCAN_K - WARMUP_STEPS:
                    raise AssertionError(f"{label} world 1 scan {mode}: "
                                         f"graph and eager steps disagree: "
                                         f"{bad}")
                for k, n in multi.replayed_launches().items():
                    counts[k] += n
    finally:
        destroy()
    return numbers


def _ddp_bf16_world1(launches: dict) -> dict:
    """(h) The headline at ``dtype: bfloat16`` in a process group of one
    rank over NCCL: per mode DDP_STEPS data-parallel and as many FSDP
    steps (nothing split at a data size of 1) against as many plain
    bfloat16 steps from an equal state on the same batches, every
    parameter, Adam moment (bfloat16 for the CT layer's own parameters),
    the generator and the last metrics bit for bit, with the plain step's
    launches; then the three timed in turns, the gradient bucket's bytes
    per dtype and the all-reduce's ms; ``make_multi_train_step(mode,
    SCAN_K)`` of a DP and of an FSDP state against eager plain steps bit
    for bit (cuDNN deterministic, as the phase "bf16" holds graph and
    eager steps); last every kernel call of one causal DP step (the
    backward ones too) against its plain version at bfloat16
    (``_bf16_kernels_on_step``). The launches of the DP and FSDP steps
    and graphs count into ``launches`` (the path "ddp_bf16")."""
    from ctvae_torch.parallel import all_reduce_grads, destroy, \
        init_distributed
    from ctvae_torch.training import make_multi_train_step, make_train_step
    from ctvae_torch.training.state import WARMUP_STEPS
    group = init_distributed(device=torch.device("cuda", 0),
                             init_method=f"tcp://127.0.0.1:{_free_port()}",
                             rank=0, world_size=1)
    numbers: dict = {"backend": torch.distributed.get_backend(group)}
    bf16 = BF16_MODEL_PARAMS
    try:
        states = {"plain": _ddp_state(None, params=bf16),
                  "dp": _ddp_state(group, params=bf16),
                  "fsdp": _ddp_state(group, fsdp=True, params=bf16)}
        plain = states["plain"]
        if states["fsdp"].fsdp.shards:
            raise AssertionError("fsdp world 1 split a parameter at bf16")
        for mode, expected in EXPECTED_TRAIN.items():
            step = make_train_step(mode)
            batches = _ddp_batches(SEED + 31, DDP_STEPS, BATCH)
            for b in batches:
                want = step(plain, b)
            for label in ("dp", "fsdp"):
                state = states[label]
                for b in batches:
                    c0 = _counts()
                    got = step(state, b)
                    c1 = _counts()
                    _add_counts(launches, c0, c1)
                    per = {k: c1[k] - c0[k] for k in c1}
                    if per != expected:
                        raise AssertionError(f"{label} bf16 world 1 {mode}: "
                                             f"launches per step {per}")
                a, b_ = _scan_tensors(plain), _scan_tensors(state)
                differ = [n for n in a if not torch.equal(a[n], b_[n])]
                differ += [f"metric {k}" for k in want
                           if not torch.equal(want[k], got[k])]
                if not torch.equal(plain.generator.get_state(),
                                   state.generator.get_state()):
                    differ.append("generator")
                kinds = sorted({str(v.dtype) for v in b_.values()})
                log(f"{label} bf16 world 1 {mode}: {len(a)} parameters and "
                    f"Adam moments ({kinds}) and {len(want)} metrics after "
                    f"{DDP_STEPS} steps, plain vs {label} over NCCL: "
                    f"{len(differ)} differ; loss {float(got['loss']):.6g}")
                if differ or "torch.bfloat16" not in kinds:
                    raise AssertionError(f"{label} bf16 world 1 {mode}: not "
                                         f"bit-equal: {differ[:8]}")
            secs = {w: [] for w in states}
            for r in range(DDP_ROUNDS):
                for which in (list(states) if r % 2 == 0
                              else list(states)[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b in batches[:DDP_TIMED]:
                        step(states[which], b)
                    torch.cuda.synchronize()
                    secs[which].append(1e3 * (time.perf_counter() - t0)
                                       / DDP_TIMED)
            numbers[f"{mode}_ms"] = {w: statistics.median(t)
                                     for w, t in secs.items()}
            log(f"ddp bf16 world 1 {mode} B={BATCH}: ms per step "
                f"{json.dumps(numbers[f'{mode}_ms'])} (medians of "
                f"{DDP_ROUNDS} rounds of {DDP_TIMED} steps in turns)")
        params = list(states["dp"].model.parameters())
        buckets: dict = {}
        for p in params:
            if p.grad is not None:
                key = str(p.grad.dtype).replace("torch.", "")
                buckets[key] = buckets.get(key, 0) + \
                    p.grad.numel() * p.grad.element_size()
        numbers["bucket_bytes"] = buckets
        if all_reduce_grads(params, group) != sum(buckets.values()):
            raise AssertionError(f"ddp bf16 buckets {buckets}")
        numbers["all_reduce_ms"] = time_ms(
            lambda: all_reduce_grads(params, group))
        log(f"ddp bf16 world 1: gradient buckets {json.dumps(buckets)} "
            f"bytes, NCCL all-reduce of both "
            f"{numbers['all_reduce_ms']:.4f} ms (median of 21)")
        numbers["scan_bit_equal"] = {}
        for mode in EXPECTED_TRAIN:
            eager = _ddp_state(None, params=bf16)
            batches = _ddp_batches(SEED + 37, 2 * SCAN_K, BATCH)
            stacked = {k: torch.stack([b[k] for b in batches])
                       for k in batches[0]}
            step = make_train_step(mode)
            for b in batches:
                step(eager, b)
            for label, fsdp in (("ddp", False), ("fsdp", True)):
                graph = _ddp_state(group, fsdp=fsdp, params=bf16)
                multi = make_multi_train_step(mode, SCAN_K)
                for half in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K)):
                    multi(graph, {k: v[half] for k, v in stacked.items()})
                torch.cuda.synchronize()
                a, b_ = _scan_tensors(eager), _scan_tensors(graph)
                differ = [n for n in a if not torch.equal(a[n], b_[n])]
                same_gen = torch.equal(eager.generator.get_state(),
                                       graph.generator.get_state())
                numbers["scan_bit_equal"][f"{label}_{mode}"] = not differ
                log(f"{label} bf16 world 1 scan {mode}: {len(a)} tensors "
                    f"after {2 * SCAN_K} steps, eager plain vs "
                    f"{multi.replays} {label} graph replays: {len(differ)} "
                    f"differ; generator equal {same_gen}")
                if differ or not same_gen or \
                        multi.replays != 2 * SCAN_K - WARMUP_STEPS:
                    raise AssertionError(f"{label} bf16 world 1 scan {mode}: "
                                         f"{differ[:8]}")
                for k, n in multi.replayed_launches().items():
                    launches[k] += n
        step = make_train_step("causal")
        b = _ddp_batches(SEED + 41, 1, BATCH)[0]
        numbers["kernels_on_causal_step"] = _bf16_kernels_on_step(
            "ddp causal step", lambda: step(states["dp"], b), timed=False)
    finally:
        destroy()
    return numbers


def _adam_reach(grad_diff: torch.Tensor, lr: float) -> torch.Tensor:
    """How far one Adam update from equal states may move two runs'
    parameters apart, given their gradients' difference: it moves a
    parameter by lr g / (|g| + 1e-8), so DDP_ATOL + lr / 1e-8 x the
    difference, as the tier-1 tests bound it (tests/torch_port_common.py::
    assert_step_matches)."""
    return DDP_ATOL + lr / 1e-8 * grad_diff


def _ddp_loop_config(root: str, epochs: int, resume=None,
                     sharding: str = "dp") -> dict:
    """The loop phase's TSynthetic run as a config for ``run.train``, with
    a validation limit of one global batch of two ranks per mode; its run
    is named after ``sharding``."""
    trainer = {"max_epochs": epochs}
    if resume:
        trainer["resume_from_checkpoint"] = resume
    exp = dict(EXP_PARAMS)
    if sharding != "dp":
        exp["sharding"] = sharding
    return {"model_params": dict(LOOP_MODEL_PARAMS),
            "data_params": {"data_path": "", "dataset_name": "TSynthetic",
                            "train_batch_size": BATCH,
                            "val_batch_size": BATCH,
                            "patch_size": MODEL_PARAMS["img_size"],
                            "limit": 48, "val_limit": 2 * BATCH,
                            "seed": SEED},
            "exp_params": exp, "trainer_params": trainer,
            "logging_params": {"save_dir": root,
                               "name": "ddp" if sharding == "dp" else sharding}}


def _state_differ(a, b, path: str = "") -> list:
    """Where two train states' ``state_dict`` differ (tensors bit for bit,
    on the CPU)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ok = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
              and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys"]
        return [d for k in a for d in _state_differ(a[k], b[k],
                                                    f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _state_differ(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _resident_bytes(state) -> int:
    """Bytes of the parameters (under FSDP the slices and the replicated
    ones) and Adam moments a state holds between steps."""
    if state.fsdp is not None:
        return state.fsdp.resident_bytes(state.optimizers)
    ts = list(state.model.parameters())
    for opt in state.optimizers:
        for st in opt.adam.state.values():
            ts += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    return sum(t.numel() * t.element_size() for t in ts)


def _fsdp_rank_steps(group, rank: int, dp_bytes: int) -> dict:
    """(e) on a rank: the headline under FSDP (``fully_shard`` over the
    two ranks at the default ``fsdp_min_size``), DDP_RANK_STEPS steps of
    each mode at B = 16 rows of each global batch of 32; before each, the
    gathered state (a collective) goes into one process on rank 0, which
    takes the step on the whole batch beside it; the gathered gradients
    and parameters after it against that process's; the launches per
    step; the resident bytes against DP's."""
    from ctvae_torch.parallel import local_rows
    from ctvae_torch.training import make_train_step
    from ctvae_torch.training.state import full_params
    fs = _ddp_state(group, fsdp=True)
    single = _ddp_state(None) if rank == 0 else None
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    wrong, losses, ms, beyond, worst = [], [], {}, [], 0.0
    lr = float(EXP_PARAMS["LR"])
    for i, (mode, expected) in enumerate(EXPECTED_TRAIN.items()):
        step = make_train_step(mode)
        secs = []
        for b in _ddp_batches(SEED + 23 + i, DDP_RANK_STEPS, 2 * BATCH):
            mine = local_rows(b, group)
            full = copy.deepcopy(fs.state_dict())
            if single is not None:
                single.load_state_dict(full)
            c0 = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = step(fs, mine)
            torch.cuda.synchronize()
            secs.append(1e3 * (time.perf_counter() - t0))
            c1 = _counts()
            _add_counts(launches, c0, c1)
            per = {k: c1[k] - c0[k] for k in c1}
            if per != expected:
                wrong.append((mode, per))
            grads, params = _full_grads_params(fs)
            if single is None:
                continue
            want = step(single, b)
            losses.append((mode, float(got["loss"]), float(want["loss"])))
            for n, q in single.model.named_parameters():
                d = (params[n] - q.detach()).abs()
                worst = max(worst, float(d.max()))
                g = (grads[n] - q.grad).abs() if n in grads \
                    else torch.zeros_like(d)
                if not bool((d <= _adam_reach(g, lr)).all()):
                    beyond.append((mode, n))
        ms[mode] = statistics.median(secs[1:])
    with full_params(fs):
        final = {n: p.detach().cpu() for n, p in
                 fs.model.named_parameters()}
    return dict(launches=launches, wrong=wrong, ms=ms, losses=losses,
                params=final, param_max_diff=worst, beyond_bound=beyond,
                split=len(fs.fsdp.shards),
                resident_bytes=_resident_bytes(fs), dp_bytes=dp_bytes)


def _full_grads_params(state) -> tuple:
    """(gradients, parameters) of the last step at their full shapes
    (under FSDP gathered from the slices: a collective)."""
    from ctvae_torch.training.state import full_params
    grads = {}
    if state.fsdp is not None:
        split = [(k, sh.grad) for k, sh in state.fsdp.shards.items()
                 if sh.grad is not None]
        grads = dict(zip([k for k, _ in split],
                         state.fsdp.gather_full(split)))
    with full_params(state):
        params = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
    grads.update({n: p.grad for n, p in state.model.named_parameters()
                  if p.grad is not None})
    return grads, params


def _bf16_rank(group, rank: int, out_dir: str) -> dict:
    """(i) on a rank: the headline at ``dtype: bfloat16`` under DP and
    under FSDP (``fully_shard`` over the two ranks), DDP_BF16_RANK_STEPS
    steps of each mode at B = 16 rows of each global batch of 32; before
    each, rank 0 loads the gathered state into one process at bfloat16
    and into one at float32 (the same values), which take the step on the
    whole batch; the losses within 5 ulps (2 %) of the bfloat16 process's,
    and tier-1's rule for a rank's step (tests/test_torch_bf16_ranks.py::
    ``assert_rank_step_matches``, the bfloat16 process the reference of
    rounding in place of JAX): each gradient within twice the bfloat16
    process's distance to the float32 one plus 2 ulps of its norm and 2
    ulps of the ranks' own gradients' magnitudes (each rank's gradient,
    a sum over its rows, is rounded to bfloat16 before the bucket adds
    the two: where they cancel, those roundings exceed the result's ulp),
    each parameter after the step within 2 ulps at the operands' scale of
    the bfloat16 process's plus Adam's reach of the two gradients'
    difference.
    Then ``run.train`` of the loop config at bfloat16 under DP, one epoch
    and a resume from rank 0's checkpoint for a second."""
    from ctvae_torch import run
    from ctvae_torch.parallel import local_rows
    from ctvae_torch.training import make_train_step
    from ctvae_torch.training import state as tstate
    bf16 = BF16_MODEL_PARAMS
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    out: dict = {"launches": launches}
    lr = float(EXP_PARAMS["LR"])
    real_reduce = tstate.all_reduce_grads
    for sharding in ("dp", "fsdp"):
        st = _ddp_state(group, fsdp=sharding == "fsdp", params=bf16)
        single = _ddp_state(None, params=bf16) if rank == 0 else None
        twin = _ddp_state(None) if rank == 0 else None
        # each rank's own gradients, |g| before the reduction
        local: dict = {}
        names = {id(p): n for n, p in st.model.named_parameters()}

        def reduce_dp(params, group, local=local, names=names):
            params = list(params)
            local.update({names[id(p)]: p.grad.detach().float().abs()
                          for p in params if p.grad is not None})
            return real_reduce(params, group)
        tstate.all_reduce_grads = reduce_dp
        if st.fsdp is not None:
            real_fsdp = st.fsdp.reduce_grads

            def reduce_fsdp(batch_group, fs=st.fsdp, real=real_fsdp,
                            local=local):
                local.update({k: p.grad.detach().float().abs()
                              for k, p in fs.params.items()
                              if p.grad is not None})
                return real(batch_group)
            st.fsdp.reduce_grads = reduce_fsdp
        wrong, rel, beyond, ratio, ms = [], [], [], 0.0, {}
        for i, (mode, expected) in enumerate(EXPECTED_TRAIN.items()):
            step = make_train_step(mode)
            secs = []
            for b in _ddp_batches(SEED + 43 + i, DDP_BF16_RANK_STEPS,
                                  2 * BATCH):
                full = copy.deepcopy(st.state_dict())
                if single is not None:
                    single.load_state_dict(full)
                    twin.model.load_state_dict(
                        {k: v.float() if v.is_floating_point() else v
                         for k, v in full["model"].items()})
                    twin.generator.set_state(full["generator"])
                c0 = _counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = step(st, local_rows(b, group))
                torch.cuda.synchronize()
                secs.append(1e3 * (time.perf_counter() - t0))
                c1 = _counts()
                _add_counts(launches, c0, c1)
                if {k: c1[k] - c0[k] for k in c1} != expected:
                    wrong.append(mode)
                grads, params = _full_grads_params(st)
                # the ranks' |g| summed (a collective), over the world
                keys = sorted(local)
                both = torch.cat([local[k].reshape(-1) for k in keys])
                torch.distributed.all_reduce(both, group=group)
                world = torch.distributed.get_world_size(group)
                own = {k: t.view_as(local[k]) / world for k, t in zip(
                    keys, both.split([local[k].numel() for k in keys]))}
                local.clear()
                if single is None:
                    continue
                want = step(single, b)
                step(twin, b)
                rel.append(abs(float(got["loss"]) - float(want["loss"]))
                           / max(abs(float(want["loss"])), 1e-30))
                for n, q in single.model.named_parameters():
                    zero = torch.zeros_like(q, dtype=torch.float64)
                    g = grads.get(n, zero).double()
                    o = (q.grad.double() if q.grad is not None else zero)
                    r = dict(twin.model.named_parameters())[n].grad
                    r = r.double() if r is not None else zero
                    bound = 2 * float((o - r).norm()) + 2 * BF16_ULP * (
                        float(r.norm()) + float(own[n].norm()) if n in own
                        else float(r.norm()))
                    e = float((g - r).norm())
                    ratio = max(ratio, e / bound if bound else 0.0)
                    qd = q.detach().double()
                    tol = 2 * BF16_ULP * (qd.abs() + lr) + \
                        _adam_reach((g - o).abs(), lr)
                    if e > bound or not bool(
                            ((params[n].double() - qd).abs() <= tol).all()):
                        beyond.append((mode, n))
            ms[mode] = statistics.median(secs[1:])
        tstate.all_reduce_grads = real_reduce
        out[sharding] = dict(
            wrong=wrong, loss_max_rel=max(rel) if rel else 0.0,
            beyond=beyond, worst_ratio=ratio, ms=ms,
            resident_bytes=_resident_bytes(st), params={
                n: p.cpu() for n, p in _full_grads_params(st)[1].items()})
        del st, single, twin
        torch.cuda.empty_cache()
    root = os.path.join(out_dir, "logs_bf16")
    cfg = _ddp_loop_config(root, 1)
    cfg["model_params"]["dtype"] = "bfloat16"
    c0 = _counts()
    t0 = time.perf_counter()
    out["first"] = run.train(cfg, device="cuda:0")
    out["fit_s"] = time.perf_counter() - t0
    cfg = _ddp_loop_config(root, 2, resume=os.path.join(
        root, "ddp", "version_0", "checkpoints", "last"))
    cfg["model_params"]["dtype"] = "bfloat16"
    out["second"] = run.train(cfg, device="cuda:0")
    _add_counts(launches, c0, _counts())
    if rank == 0:
        blob = torch.load(os.path.join(root, "ddp", "version_1",
                                       "checkpoints", "last"),
                          map_location="cpu", weights_only=True)
        out["ckpt_dtypes"] = sorted({str(v.dtype) for v in
                                     blob["model"].values()})
        out["moment_dtypes"] = sorted({
            str(st[k].dtype) for o in blob["optimizers"]
            for st in o["adam"]["state"].values()
            for k in ("exp_avg", "exp_avg_sq")})
    return out


def _fsdp_rank_fit(rank: int, out_dir: str) -> dict:
    """(f) on a rank: ``run.train`` of the loop config under ``sharding:
    fsdp`` for one epoch, a resume from rank 0's checkpoint for a second;
    rank 0 then loads the last checkpoint into one process, whose state
    must equal the file's."""
    from ctvae_torch import run
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state
    root = os.path.join(out_dir, "logs_fsdp")
    c0 = _counts()
    t0 = time.perf_counter()
    first = run.train(_ddp_loop_config(root, 1, sharding="fsdp"),
                      device="cuda:0")
    out = {"fit_s": time.perf_counter() - t0, "first": first}
    last = os.path.join(root, "fsdp", "version_0", "checkpoints", "last")
    out["second"] = run.train(_ddp_loop_config(root, 2, resume=last,
                                               sharding="fsdp"),
                              device="cuda:0")
    c1 = _counts()
    out["launches"] = {k: c1[k] - c0[k] for k in c1}
    if rank == 0:
        last = os.path.join(root, "fsdp", "version_1", "checkpoints", "last")
        blob = torch.load(last, map_location="cpu", weights_only=True)
        model = build_model(LOOP_MODEL_PARAMS, device="cuda")
        one = create_train_state(model, build_optimizers(
            EXP_PARAMS, model, steps_per_epoch=100))
        one.load_state_dict(blob)
        # parameters, Adam's moments and step counts, schedule position,
        # step, generator (the groups' settings are this device's form)
        def core(sd):
            return [sd["model"], sd["step"], sd["generator"],
                    [(o["adam"]["state"], o["count"])
                     for o in sd["optimizers"]]]
        out["one_process_differ"] = _state_differ(core(one.state_dict()),
                                                  core(blob))
        out["ckpt_step"] = blob["step"]
    return out


def _cross_batch_rank(group, rank: int) -> dict:
    """(g) on a rank: each CROSS_BATCH_YAMLS config as written (its model
    and exp_params, B = its train_batch_size a rank, 64 x 64 images
    drawn on the CPU from a seed), CROSS_BATCH_STEPS steps at M_N =
    kld_weight; before each, rank 0 loads the state into one process,
    which takes the step on the global batch beside it: every loss term
    and the parameters after it against that process's."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import local_rows, put_replicated
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    out = {}
    for j, name in enumerate(CROSS_BATCH_YAMLS):
        cfg = read_config(os.path.join(os.path.dirname(CONFIG),
                                       f"{name}.yaml"))
        exp = _exp_params(cfg)
        B = int(cfg["data_params"]["train_batch_size"])
        s = int(cfg["data_params"]["patch_size"])

        def state_of(g):
            model = build_model(cfg["model_params"], device="cuda",
                                generator=torch.Generator(
                                    "cuda").manual_seed(SEED))
            st = create_train_state(model, build_optimizers(
                exp, model, steps_per_epoch=100), seed=SEED, group=g)
            put_replicated(model, g, st.generator)
            return st
        dp = state_of(group)
        single = state_of(None) if rank == 0 else None
        step = make_train_step("base", M_N=float(exp.get("kld_weight", 1.0)))
        gen = torch.Generator().manual_seed(SEED + 31 + j)
        lr = float(exp["LR"])
        res = {"rel": 0.0, "beyond": [], "finite": True, "ms": []}
        for _ in range(CROSS_BATCH_STEPS):
            b = {"image": torch.rand(2 * B, s, s, 3, generator=gen).cuda()}
            if single is not None:
                single.load_state_dict(copy.deepcopy(dp.state_dict()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = step(dp, local_rows(b, group))
            torch.cuda.synchronize()
            res["ms"].append(1e3 * (time.perf_counter() - t0))
            res["finite"] &= all(bool(torch.isfinite(v).all())
                                 for v in got.values())
            if single is None:
                continue
            want = step(single, b)
            for k, v in want.items():
                if v.dim() == 0 and v.is_floating_point():
                    d = abs(float(got[k]) - float(v))
                    res["rel"] = max(res["rel"],
                                     d / max(abs(float(v)), 1e-30))
            for (n, p), q in zip(dp.model.named_parameters(),
                                 single.model.parameters()):
                d = (p.detach() - q.detach()).abs()
                g = (p.grad - q.grad).abs() if p.grad is not None \
                    else torch.zeros_like(d)
                if not bool((d <= _adam_reach(g, lr)).all()):
                    res["beyond"].append(n)
        res["loss"] = float(got["loss"])
        out[name] = res
        del dp, single
        torch.cuda.empty_cache()
    return out


def _ddp_rank(rank: int, port: int, out_dir: str) -> None:
    """A rank of (b), (c) and (e)-(g): two ranks over gloo sharing
    cuda:0. (b)
    DDP_RANK_STEPS steps of each mode at B = 16 rows of each global batch
    of 32; before each, rank 0 loads its state into one process, which
    takes the step on the whole global batch beside it (from equal
    states, so two Adam runs' drift on gradients of rounding noise does
    not add up over the steps); (c) ``run.train`` of the loop config, one
    epoch, then a resume from rank 0's checkpoint for a second; (e)
    ``_fsdp_rank_steps``, (f) ``_fsdp_rank_fit``, (g)
    ``_cross_batch_rank``, (i) ``_bf16_rank``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from ctvae_torch import run
    from ctvae_torch.parallel import destroy, init_distributed, local_rows
    from ctvae_torch.training import make_train_step
    res: dict = {"rank": rank}
    try:
        group = init_distributed("gloo",
                                 init_method=f"tcp://127.0.0.1:{port}",
                                 rank=rank, world_size=2)
        dp = _ddp_state(group)
        single = _ddp_state(None) if rank == 0 else None
        launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
        wrong, losses, ms, beyond, worst = [], [], {}, [], 0.0
        lr = float(EXP_PARAMS["LR"])
        for i, (mode, expected) in enumerate(EXPECTED_TRAIN.items()):
            step = make_train_step(mode)
            secs = []
            for b in _ddp_batches(SEED + 17 + i, DDP_RANK_STEPS, 2 * BATCH):
                mine = local_rows(b, group)
                if single is not None:
                    single.load_state_dict(copy.deepcopy(dp.state_dict()))
                c0 = _counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = step(dp, mine)
                torch.cuda.synchronize()
                secs.append(1e3 * (time.perf_counter() - t0))
                c1 = _counts()
                _add_counts(launches, c0, c1)
                per = {k: c1[k] - c0[k] for k in c1}
                if per != expected:
                    wrong.append((mode, per))
                if single is not None:
                    want = step(single, b)
                    losses.append((mode, float(got["loss"]),
                                   float(want["loss"])))
                    for (n, p), q in zip(dp.model.named_parameters(),
                                         single.model.parameters()):
                        d = (p.detach() - q.detach()).abs()
                        worst = max(worst, float(d.max()))
                        g = (p.grad - q.grad).abs() if p.grad is not None \
                            else torch.zeros_like(d)
                        if not bool((d <= _adam_reach(g, lr)).all()):
                            beyond.append((mode, n))
            ms[mode] = statistics.median(secs[1:])
        res.update(launches=launches, wrong=wrong, ms=ms, losses=losses,
                   params={n: p.detach().cpu() for n, p in
                           dp.model.named_parameters()},
                   param_max_diff=worst, beyond_bound=beyond)
        dp_bytes = _resident_bytes(dp)
        del dp, single
        torch.cuda.empty_cache()
        # (e) the same steps under FSDP
        res["fsdp"] = _fsdp_rank_steps(group, rank, dp_bytes)
        torch.cuda.empty_cache()
        # (c) run.train over the group; rank 0 alone writes
        root = os.path.join(out_dir, "logs")
        saves = []
        real_save = torch.save

        def spy(obj, f, *a, **k):
            saves.append(str(f))
            return real_save(obj, f, *a, **k)
        torch.save = spy
        try:
            c0 = _counts()
            t0 = time.perf_counter()
            first = run.train(_ddp_loop_config(root, 1), device="cuda:0")
            res["fit_s"] = time.perf_counter() - t0
            c1 = _counts()
            _add_counts(launches, c0, c1)
            last = os.path.join(root, "ddp", "version_0", "checkpoints",
                                "last")
            second = run.train(_ddp_loop_config(root, 2, resume=last),
                               device="cuda:0")
        finally:
            torch.save = real_save
        res.update(first=first, second=second, saves=saves)
        # (f) run.train under FSDP, a resume, one process loads it
        res["fsdp_fit"] = _fsdp_rank_fit(rank, out_dir)
        # (g) the cross-batch losses as written
        res["cross_batch"] = _cross_batch_rank(group, rank)
        torch.cuda.empty_cache()
        # (i) bfloat16 under DP and FSDP, and run.train at bfloat16
        res["bf16"] = _bf16_rank(group, rank, out_dir)
    except Exception:       # reported to the parent, which fails the phase
        import traceback
        res["error"] = traceback.format_exc()
    finally:
        destroy()
        torch.save(res, os.path.join(out_dir, f"ddp_rank{rank}.pt"))


def _ddp_two_ranks(launches: dict, fsdp_launches: dict, bf16_launches: dict,
                   smi: str) -> dict:
    """(b), (c), (e)-(g) and (i): the two ranks, spawned after the kernels
    are built (the ranks load the libraries the parent built), joined
    within DDP_TIMEOUT seconds or killed."""
    import torch.multiprocessing as mp
    numbers: dict = {}
    with tempfile.TemporaryDirectory(prefix="ctvae_ddp_") as tmp:
        ctx = mp.start_processes(_ddp_rank, args=(_free_port(), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + DDP_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline
                                           - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"ddp: the ranks ran past "
                                         f"{DDP_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        r0, r1 = (torch.load(os.path.join(tmp, f"ddp_rank{r}.pt"),
                             weights_only=False) for r in range(2))
        for r in (r0, r1):
            if "error" in r:
                raise AssertionError(f"ddp rank {r['rank']}:\n{r['error']}")
        runs = sorted(os.listdir(os.path.join(tmp, "logs", "ddp")))
        ckpts = sorted(os.listdir(os.path.join(tmp, "logs", "ddp",
                                               "version_0", "checkpoints")))
    for r in (r0, r1):
        _add_counts(launches, {k: 0 for k in launches}, r["launches"])
        for part in (r["fsdp"]["launches"], r["fsdp_fit"]["launches"]):
            _add_counts(fsdp_launches, {k: 0 for k in fsdp_launches}, part)
        _add_counts(bf16_launches, {k: 0 for k in bf16_launches},
                    r["bf16"]["launches"])
    numbers["fsdp"] = _fsdp_two_ranks(r0, r1, smi)
    numbers["bf16"] = _bf16_two_ranks(r0["bf16"], r1["bf16"], smi)
    rel = [abs(g - w) / max(abs(w), 1e-30) for _, g, w in r0["losses"]]
    same = [n for n, t in r0["params"].items()
            if not torch.equal(t, r1["params"][n])]
    numbers.update(
        rank_ms=r0["ms"], rank1_ms=r1["ms"], loss_max_rel=max(rel),
        param_max_diff=r0["param_max_diff"],
        params_beyond_bound=r0["beyond_bound"], ranks_differ=same,
        fit_s=r0["fit_s"],
        images_per_sec={str(r["rank"]): r["first"]["train_images_per_sec"]
                        for r in (r0, r1)},
        runs=runs, checkpoints=ckpts,
        saves=[len(r0["saves"]), len(r1["saves"])],
        resumed_val_loss=r0["second"]["val_loss"])
    log(f"ddp two ranks on one card over gloo ({smi}), a correctness path "
        f"(both ranks share the card; not a scaling figure): ms per step "
        f"at B = 16 a rank, rank 0 {json.dumps(r0['ms'])}, rank 1 "
        f"{json.dumps(r1['ms'])}; each step against one process at B = 32 "
        f"from the same state: losses' largest relative difference "
        f"{max(rel):.3g} over {len(rel)} steps, parameters' largest "
        f"difference {r0['param_max_diff']:.3g} (beyond Adam's reach of "
        f"the gradients' difference: {r0['beyond_bound']}); after the "
        f"steps the ranks' parameters differ in "
        f"{len(same)} tensors; launches per step off the plain step's "
        f"{r0['wrong'] + r1['wrong']}")
    log(f"ddp run.train at world 2 over gloo: one epoch in "
        f"{r0['fit_s']:.2f} s, images/s per rank "
        f"{json.dumps(numbers['images_per_sec'])} (global "
        f"{sum(numbers['images_per_sec'].values()):.1f}); run directories "
        f"{runs}; version_0 checkpoints {ckpts}; checkpoint writes rank 0 "
        f"{len(r0['saves'])}, rank 1 {len(r1['saves'])}; the resumed run's "
        f"val_loss {r0['second']['val_loss']:.6g} (rank 1 "
        f"{r1['second']['val_loss']:.6g})")
    if max(rel) > DDP_RTOL or r0["beyond_bound"] or same or \
            r0["wrong"] or r1["wrong"]:
        raise AssertionError("ddp two ranks: disagree with one process or "
                             "each other")
    if runs != ["version_0", "version_1"] or "last" not in ckpts or \
            not r0["saves"] or r1["saves"] or \
            r0["second"]["val_loss"] != r1["second"]["val_loss"]:
        raise AssertionError(f"ddp run.train: runs {runs}, checkpoints "
                             f"{ckpts}, writes {numbers['saves']}")
    return numbers


def _bf16_two_ranks(b0: dict, b1: dict, smi: str) -> dict:
    """(i) from the two ranks' results: checked, logged, returned."""
    numbers = {}
    for sharding in ("dp", "fsdp"):
        a, b = b0[sharding], b1[sharding]
        differ = [n for n, t in a["params"].items()
                  if not torch.equal(t, b["params"][n])]
        numbers[sharding] = dict(
            rank_ms=a["ms"], rank1_ms=b["ms"],
            loss_max_rel=a["loss_max_rel"], worst_ratio=a["worst_ratio"],
            beyond=a["beyond"], ranks_differ=differ,
            resident_bytes=[a["resident_bytes"], b["resident_bytes"]])
        log(f"{sharding} bf16 two ranks on one card over gloo ({smi}), a "
            f"correctness path: ms per step at B = 16 a rank "
            f"{json.dumps(a['ms'])}; each step against one process at "
            f"B = 32 from the same state: losses' largest relative "
            f"difference {a['loss_max_rel']:.3g}, the largest gradient "
            f"distance over its bound {a['worst_ratio']:.3g} (beyond: "
            f"{a['beyond']}); the ranks' parameters differ in {len(differ)} "
            f"tensors; resident bytes of parameters and Adam moments per "
            f"rank {numbers[sharding]['resident_bytes']}; launches off the "
            f"plain step's {a['wrong'] + b['wrong']}")
        if a["loss_max_rel"] > 5 * BF16_ULP or a["beyond"] or differ or \
                a["wrong"] or b["wrong"]:
            raise AssertionError(f"{sharding} bf16 two ranks: "
                                 f"{numbers[sharding]}")
    numbers.update(fit_s=b0["fit_s"], ckpt_dtypes=b0["ckpt_dtypes"],
                   moment_dtypes=b0["moment_dtypes"],
                   resumed_val_loss=b0["second"]["val_loss"])
    log(f"ddp run.train at world 2 over gloo at bf16: one epoch in "
        f"{b0['fit_s']:.2f} s; the resumed run's val_loss "
        f"{b0['second']['val_loss']:.6g} (rank 1 "
        f"{b1['second']['val_loss']:.6g}); checkpoint dtypes "
        f"{b0['ckpt_dtypes']}, Adam moments {b0['moment_dtypes']}")
    if b0["second"]["val_loss"] != b1["second"]["val_loss"] or \
            "torch.bfloat16" not in b0["moment_dtypes"]:
        raise AssertionError(f"ddp run.train at bf16: {numbers}")
    return numbers


def _fsdp_two_ranks(r0: dict, r1: dict, smi: str) -> dict:
    """(e)-(g) from the two ranks' results: checked, logged, returned."""
    e0, e1 = r0["fsdp"], r1["fsdp"]
    rel = [abs(g - w) / max(abs(w), 1e-30) for _, g, w in e0["losses"]]
    same = [n for n, t in e0["params"].items()
            if not torch.equal(t, e1["params"][n])]
    f0, f1 = r0["fsdp_fit"], r1["fsdp_fit"]
    cross = r0["cross_batch"]
    numbers = dict(
        rank_ms=e0["ms"], rank1_ms=e1["ms"], loss_max_rel=max(rel),
        param_max_diff=e0["param_max_diff"], split=e0["split"],
        params_beyond_bound=e0["beyond_bound"], ranks_differ=same,
        resident_bytes=[e0["resident_bytes"], e1["resident_bytes"]],
        dp_resident_bytes=[e0["dp_bytes"], e1["dp_bytes"]],
        fit_s=f0["fit_s"], resumed_val_loss=f0["second"]["val_loss"],
        images_per_sec={str(r["rank"]): r["fsdp_fit"]["first"][
            "train_images_per_sec"] for r in (r0, r1)},
        one_process_differ=f0["one_process_differ"],
        cross_batch={k: {"loss_max_rel": v["rel"], "beyond": v["beyond"],
                         "ms": [round(t, 3) for t in v["ms"]],
                         "loss": v["loss"]} for k, v in cross.items()})
    log(f"fsdp two ranks on one card over gloo ({smi}), a correctness path: "
        f"{e0['split']} parameters split; ms per step at B = 16 a rank, rank "
        f"0 {json.dumps(e0['ms'])}, rank 1 {json.dumps(e1['ms'])}; each "
        f"step against one process at B = 32 from rank 0's gathered state: "
        f"losses' largest relative difference {max(rel):.3g} over "
        f"{len(rel)} steps, parameters' largest difference "
        f"{e0['param_max_diff']:.3g} (beyond Adam's reach of the gradients' "
        f"difference: {e0['beyond_bound']}); the ranks' gathered parameters "
        f"differ in {len(same)} tensors; launches per step off the plain "
        f"step's {e0['wrong'] + e1['wrong']}; resident bytes of parameters "
        f"and Adam moments per rank between steps: fsdp "
        f"{numbers['resident_bytes']}, dp {numbers['dp_resident_bytes']}")
    log(f"fsdp run.train at world 2 over gloo: one epoch in "
        f"{f0['fit_s']:.2f} s, images/s per rank "
        f"{json.dumps(numbers['images_per_sec'])} (global "
        f"{sum(numbers['images_per_sec'].values()):.1f}); the resumed run's "
        f"val_loss "
        f"{f0['second']['val_loss']:.6g} (rank 1 "
        f"{f1['second']['val_loss']:.6g}); its last checkpoint (step "
        f"{f0['ckpt_step']}) loaded by one process: differs in "
        f"{f0['one_process_differ']}")
    for name, v in cross.items():
        log(f"cross-batch {name} at world 2 over gloo, B = 64 a rank: "
            f"losses' largest relative difference from one process at "
            f"B = 128 {v['rel']:.3g} over {CROSS_BATCH_STEPS} steps, "
            f"parameters beyond Adam's reach {v['beyond']}, finite "
            f"{v['finite'] and r1['cross_batch'][name]['finite']}, ms per "
            f"step {json.dumps([round(t, 3) for t in v['ms']])}, last loss "
            f"{v['loss']:.6g}")
    if max(rel) > DDP_RTOL or e0["beyond_bound"] or same or e0["wrong"] \
            or e1["wrong"] or not e0["split"] or \
            max(numbers["resident_bytes"]) >= min(
                numbers["dp_resident_bytes"]):
        raise AssertionError("fsdp two ranks: disagree with one process or "
                             "each other, or hold no less than DP")
    if f0["one_process_differ"] or \
            f0["second"]["val_loss"] != f1["second"]["val_loss"]:
        raise AssertionError(f"fsdp run.train: {f0['one_process_differ']}")
    bad = {k: v for k, v in cross.items()
           if v["rel"] > DDP_RTOL or v["beyond"] or not v["finite"]
           or not r1["cross_batch"][k]["finite"]}
    if bad:
        raise AssertionError(f"cross-batch losses at world 2: {bad}")
    return numbers


def phase_ddp(smi: str) -> tuple:
    """Data-parallel training of the headline model (configs/
    ct_mcq_vae.yaml at full width, ``ct_layer`` trained) under cuDNN's
    deterministic algorithms: (a) and (d) ``_ddp_world1``, (b), (c) and
    (e)-(g) ``_ddp_two_ranks``. The launch counters of every
    data-parallel step are the path "ddp", those of every FSDP step (d)-(f)
    the path "fsdp" ((g)'s models launch none), those of the bfloat16
    parts (h) ``_ddp_bf16_world1`` and (i) ``_bf16_rank`` the path
    "ddp_bf16". Returns (those three launches, the numbers)."""
    start = time.perf_counter()
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    fsdp_launches, bf16_launches = dict(launches), dict(launches)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        numbers = {"world1": walled("ddp.world1", _ddp_world1, launches,
                                    fsdp_launches)}
        t0 = time.perf_counter()
        numbers["bf16_world1"] = walled("ddp.bf16_world1", _ddp_bf16_world1,
                                        bf16_launches)
        numbers["bf16_world1"]["wall_s"] = time.perf_counter() - t0
        numbers["two_ranks"] = walled("ddp.two_ranks", _ddp_two_ranks,
                                      launches, fsdp_launches,
                                      bf16_launches, smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    numbers["wall_s"] = time.perf_counter() - start
    log(f"launches on the ddp path: {json.dumps(launches)}")
    log(f"launches on the fsdp path: {json.dumps(fsdp_launches)}")
    log(f"launches on the ddp_bf16 path: {json.dumps(bf16_launches)}")
    log(f"ddp: phase {numbers['wall_s']:.1f} s (bf16 world 1 "
        f"{numbers['bf16_world1']['wall_s']:.1f} s)")
    return launches, fsdp_launches, bf16_launches, numbers


# --- phase "sp": sequence parallelism --------------------------------------

SP_PARAMS = {**MODEL_PARAMS, "seq_axis": "model"}
SP_STEPS = 8          # steps of each mode on the two ranks and in one process
SP_BF16_STEPS = 3     # causal steps at bfloat16
SP_TIMEOUT = 400      # seconds for the two rank processes
SP_TOL = 1e-5         # tier-1's bound: losses (atol and rtol), and each
                      # gradient over max(1, its leaf's largest |g|)
SP_REQUEST_ATOL = 1e-5  # classify_action's probabilities against one
                        # process; the images may differ in 1% of their
                        # elements (a code flipped at a near-tie)


def _sp_state(params, batch_group=None, model_group=None):
    """The headline model of ``params`` and the config's exp_params, seeded
    as ``_ddp_state``; a state with a model group gets rank 0's weights and
    generator (a broadcast over the world, so every rank calls it)."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import put_replicated
    from ctvae_torch.training import build_optimizers, create_train_state
    model = build_model(params, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(model, [], seed=SEED, group=batch_group,
                               model_group=model_group)
    if model_group is not None:
        put_replicated(model, torch.distributed.group.WORLD, state.generator)
    state.optimizers = build_optimizers(EXP_PARAMS, model,
                                        steps_per_epoch=100)
    return state


class _SpBytes:
    """While open, the bytes of each collective of the split region: the
    gathers (their padded output, every rank's block) and the entry's
    gradient sums (their float32 bucket), by shape."""

    def __enter__(self):
        from ctvae_torch.parallel import sequence as sq
        self.sq, self.real = sq, (sq._gather_dim0, sq.sum_grads)
        self.gathers, self.sums = [], []

        def gather(t, group):
            self.gathers.append((list(t.shape), t.numel() * t.element_size()
                                 * torch.distributed.get_world_size(group)))
            return self.real[0](t, group)

        def sums(grads, group):
            n = sum(g.numel() for g in grads if g is not None)
            self.sums.append(([list(g.shape) for g in grads
                               if g is not None], 4 * n))
            return self.real[1](grads, group)
        sq._gather_dim0, sq.sum_grads = gather, sums
        return self

    def __exit__(self, *exc):
        self.sq._gather_dim0, self.sq.sum_grads = self.real

    def numbers(self) -> dict:
        return {"gather_bytes": sum(b for _, b in self.gathers),
                "sum_bytes": sum(b for _, b in self.sums),
                "gathers": self.gathers, "sums": self.sums}


#: each split kernel's launch, by wrapper: (argument holding the targets,
#: its dim)
SP_SPLIT = {("pairwise_flash", "flash_pairwise_cuda"): (1, 1),
            ("pairwise_flash", "flash_pairwise_bwd_cuda"): (1, 1),
            ("gat_flash", "flash_gat_cuda"): (1, 1),
            ("gat_flash", "flash_gat_bwd_cuda"): (1, 1),
            ("gat_logits", "fused_gat_logits_cuda"): (1, 1),
            ("gat_logits", "fused_gat_logits_bwd_cuda"): (1, 1)}


def _sp_targets(fn) -> dict:
    """Wrapper -> [(sources, targets)] of each launch of a split kernel
    while ``fn()`` runs, and the alpha residuals' shapes."""
    import importlib
    out, patched = {"alpha": []}, []
    for (mod, name), (i, d) in SP_SPLIT.items():
        module = importlib.import_module(f"ctvae_torch.ops.{mod}")
        real = getattr(module, name)

        def probe(*args, real=real, name=name, i=i, d=d, **kw):
            res = real(*args, **kw)
            out.setdefault(name, []).append((int(args[0].shape[1]),
                                             int(args[i].shape[d])))
            if name == "flash_gat_cuda" and res[1] is not None:
                out["alpha"].append(list(res[1].shape))
            return res
        setattr(module, name, probe)
        patched.append((module, name, real))
    try:
        fn()
    finally:
        for module, name, real in patched:
            setattr(module, name, real)
    return out


def _sp_grads_against(sp, single) -> tuple:
    """(worst gradient error over its leaf's scale, the leaves past
    SP_TOL, the parameters past Adam's reach of their gradients'
    difference) of a step from equal states."""
    lr = float(EXP_PARAMS["LR"])
    worst, grads, params = 0.0, [], []
    for (n, p), q in zip(sp.model.named_parameters(),
                         single.model.parameters()):
        gp = p.grad if p.grad is not None else torch.zeros_like(p)
        gq = q.grad if q.grad is not None else torch.zeros_like(q)
        diff = (gp - gq).abs()
        err = float(diff.max()) / max(1.0, float(gq.abs().max()))
        worst = max(worst, err)
        if err > SP_TOL:
            grads.append(n)
        if not bool(((p.detach() - q.detach()).abs()
                     <= _adam_reach(diff, lr)).all()):
            params.append(n)
    return worst, grads, params


def _sp_steps(sp, single, launches: dict) -> dict:
    """SP_STEPS steps of each mode on the rank (the same B = 16 rows on
    both: a data axis of 1); before each, rank 0 loads the state into one
    process, which takes the step beside it. Per mode: the step's ms, the
    transient peak bytes of its first step on the rank and in the one
    process, the collectives' bytes of that step; the launches per step
    against the plain step's; the losses and gradients against one
    process to tier-1's bound."""
    from ctvae_torch.training import make_train_step
    out = {"wrong": [], "metrics_off": [], "grads_off": [],
           "params_off": [], "worst_grad": 0.0, "worst_loss_rel": 0.0,
           "ms": {}, "peak": {}, "bytes": {}}
    for i, (mode, expected) in enumerate(EXPECTED_TRAIN.items()):
        step = make_train_step(mode)
        secs = []
        for k, b in enumerate(_ddp_batches(SEED + 61 + i, SP_STEPS, BATCH)):
            if single is not None:
                single.load_state_dict(copy.deepcopy(sp.state_dict()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            c0 = _counts()
            t0 = time.perf_counter()
            with _SpBytes() as probe:
                got = step(sp, b)
            torch.cuda.synchronize()
            secs.append(1e3 * (time.perf_counter() - t0))
            c1 = _counts()
            _add_counts(launches, c0, c1)
            if {k2: c1[k2] - c0[k2] for k2 in c1} != expected:
                out["wrong"].append(mode)
            if k == 0:
                out["peak"][mode] = {
                    "sp": torch.cuda.max_memory_allocated() - base}
                out["bytes"][mode] = probe.numbers()
            if single is None:
                continue
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            want = step(single, b)
            if k == 0:
                out["peak"][mode]["single"] = \
                    torch.cuda.max_memory_allocated() - base
            for key, w in want.items():
                # each element within SP_TOL (atol and rtol)
                g, w = got[key].double(), w.double()
                off = float(((g - w).abs() / (1 + w.abs())).max())
                out["worst_loss_rel"] = max(out["worst_loss_rel"], off)
                if off > SP_TOL:
                    out["metrics_off"].append((mode, key, off))
            worst, grads, params = _sp_grads_against(sp, single)
            out["worst_grad"] = max(out["worst_grad"], worst)
            out["grads_off"] += [(mode, n) for n in grads]
            out["params_off"] += [(mode, n) for n in params]
        out["ms"][mode] = statistics.median(secs[1:])
    return out


def _sp_requests(sp, single, mg, launches: dict) -> dict:
    """The three entry points on the rank under ``model_parallel`` (each
    launch count per request as the serving path's), against one process
    on rank 0 with the same draws: classify_action's probabilities within
    SP_REQUEST_ATOL, the images' largest difference and share of
    differing elements (held to 1%)."""
    from ctvae_torch.parallel import model_parallel
    from ctvae_torch.serving.inference import make_inference_fn
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 5), BATCH,
                        "cuda")

    def run(model):
        fns = {n: make_inference_fn(model, n) for n in EXPECTED}
        calls = {"reconstruct": lambda g: fns["reconstruct"](x, generator=g),
                 "apply_action": lambda g: fns["apply_action"](
                     x, y, a, generator=g),
                 "classify_action": lambda g: fns["classify_action"](
                     x, y, generator=g)}
        outs, wrong = {}, []
        for name, call in calls.items():
            c0 = _counts()
            outs[name] = call(torch.Generator("cuda").manual_seed(SEED))
            c1 = _counts()
            if model is sp.model:
                _add_counts(launches, c0, c1)
                if {k: c1[k] - c0[k] for k in c1} != EXPECTED[name]:
                    wrong.append(name)
            _check_served(name, outs[name], BATCH)
        return outs, wrong
    with torch.no_grad():
        with model_parallel(mg):
            got, wrong = run(sp.model)
        if single is None:
            return {"wrong": wrong}
        single.load_state_dict(copy.deepcopy(sp.state_dict()))
        want, _ = run(single.model)
    out = {"wrong": wrong}
    for name in EXPECTED:
        d = (got[name] - want[name]).abs()
        out[name] = {"max_abs_err": float(d.max()),
                     "differ_share": float((d > 0).float().mean())}
    return out


def _sp_bf16(bg, mg, rank: int, launches: dict) -> dict:
    """SP_BF16_STEPS causal steps at bfloat16 on the rank; before each,
    rank 0 loads the state into one bfloat16 process and one float32
    process (the same values), which take the step beside it: the losses
    within 2 % of the bfloat16 process's, and tier-1's rule: each
    gradient within twice the bfloat16 process's distance to the float32
    one plus 2 bfloat16 ulps of its norm."""
    from ctvae_torch.training import make_train_step
    bf = _sp_state({**BF16_MODEL_PARAMS, "seq_axis": "model"}, bg, mg)
    single = _sp_state(BF16_MODEL_PARAMS) if rank == 0 else None
    twin = _sp_state(MODEL_PARAMS) if rank == 0 else None
    step = make_train_step("causal")
    out = {"loss_max_rel": 0.0, "worst_ratio": 0.0, "beyond": [],
           "wrong": []}
    for b in _ddp_batches(SEED + 81, SP_BF16_STEPS, BATCH):
        full = copy.deepcopy(bf.state_dict())
        if single is not None:
            single.load_state_dict(full)
            twin.model.load_state_dict(
                {k: v.float() if v.is_floating_point() else v
                 for k, v in full["model"].items()})
            twin.generator.set_state(full["generator"])
        c0 = _counts()
        got = step(bf, b)
        c1 = _counts()
        _add_counts(launches, c0, c1)
        if {k: c1[k] - c0[k] for k in c1} != EXPECTED_TRAIN["causal"]:
            out["wrong"].append("causal")
        if single is None:
            continue
        want = step(single, b)
        step(twin, b)
        out["loss_max_rel"] = max(out["loss_max_rel"], abs(
            float(got["loss"]) - float(want["loss"])) / max(
            abs(float(want["loss"])), 1e-30))
        ref = dict(twin.model.named_parameters())
        for (n, p), q in zip(bf.model.named_parameters(),
                             single.model.parameters()):
            zero = torch.zeros(p.shape, dtype=torch.float64, device="cuda")
            g = p.grad.double() if p.grad is not None else zero
            o = q.grad.double() if q.grad is not None else zero
            r = ref[n].grad.double() if ref[n].grad is not None else zero
            bound = 2 * float((o - r).norm()) + 2 * BF16_ULP * float(
                r.norm())
            e = float((g - r).norm())
            out["worst_ratio"] = max(out["worst_ratio"],
                                     e / bound if bound else 0.0)
            if e > bound:
                out["beyond"].append(n)
    return out


def _sp_rank(rank: int, port: int, out_dir: str) -> None:
    """A rank of phase "sp": two ranks over gloo sharing cuda:0, one mesh
    (data 1, model 2), the headline at full width with ``seq_axis``:
    ``_sp_steps``, the kernels of one causal step at the rank's block of
    targets (``_sp_targets``) and each held against its plain version
    (``_kernels_on_step``, ``_vq_on_path``), then timed with its bound and
    plain version with each rank alone on the card in turn (``_sp_times``),
    ``_sp_requests``, ``_sp_bf16``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from ctvae_torch.parallel import (destroy, init_distributed, make_mesh,
                                      mesh_batch_group, mesh_model_group)
    from ctvae_torch.parallel.sequence import target_blocks
    from ctvae_torch.training import make_train_step
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    res: dict = {"rank": rank, "launches": launches}
    try:
        init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2)
        mesh = make_mesh(2)
        bg, mg = mesh_batch_group(mesh), mesh_model_group(mesh)
        sp = _sp_state(SP_PARAMS, bg, mg)
        single = _sp_state(MODEL_PARAMS) if rank == 0 else None
        res["steps"] = _sp_steps(sp, single, launches)
        b = _ddp_batches(SEED + 71, 1, BATCH)[0]
        causal = make_train_step("causal")
        res["targets"] = _sp_targets(lambda: causal(sp, b))
        S = (MODEL_PARAMS["img_size"] // 8) ** 2 * MODEL_PARAMS["codebooks"]
        res["blocks"] = {"pairwise": target_blocks(S, 2)[rank],
                         "gat": target_blocks(S + 1, 2)[rank]}
        res["on_step"] = _kernels_on_step(f"sp rank {rank} causal step",
                                          lambda: causal(sp, b))
        res["vq"] = _vq_on_path(lambda: causal(sp, b))
        # the block calls' times, each rank alone on the card in turn
        calls = _step_kernel_calls(lambda: causal(sp, b))
        for turn in range(2):
            torch.distributed.barrier()
            if turn == rank:
                res["times"] = _sp_times(calls)
        torch.distributed.barrier()
        del calls
        res["requests"] = _sp_requests(sp, single, mg, launches)
        del sp, single
        torch.cuda.empty_cache()
        res["bf16"] = _sp_bf16(bg, mg, rank, launches)
    except Exception:       # reported to the parent, which fails the phase
        import traceback
        res["error"] = traceback.format_exc()
    finally:
        destroy()
        torch.save(res, os.path.join(out_dir, f"sp_rank{rank}.pt"))


def _sp_times(calls) -> dict:
    """Each split kernel's ms on its call of the step (``_step_kernel_
    calls``), its bound and its plain version's ms
    (``_plain_ms_of_calls``), by kernel (the pairwise ones by call)."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops import pairwise_flash as pf

    def det(args):
        return tuple(a.detach() if torch.is_tensor(a) else a for a in args)
    out = {"ms": {}, "bound_ms": {}}
    for args, _ in calls["flash_pairwise_cuda"]:
        args = det(args)
        key = "pairwise_fwd_" + ("no_inter" if args[2].dim() == 1
                                 else "inter")
        out["ms"][key] = time_ms(lambda: pf.flash_pairwise_cuda(*args))
        out["bound_ms"][key] = _pairwise_fwd_bound(args)[0]
    for args, _ in calls["flash_pairwise_bwd_cuda"]:
        args = det(args)
        key = "pairwise_bwd_" + ("no_inter" if args[2].dim() == 1
                                 else "inter")
        out["ms"][key] = time_ms(lambda: pf.flash_pairwise_bwd_cuda(*args))
        out["bound_ms"][key] = _pairwise_bwd_bound(
            args, _pairwise_live(args)["pairs"])[0]
    (args, kw), = calls["flash_gat_cuda"]
    args = det(args)
    out["ms"]["gat_fwd"] = time_ms(lambda: gf.flash_gat_cuda(*args, **kw))
    out["bound_ms"]["gat_fwd"] = _gat_fwd_bound(
        args, kw.get("keep_alpha", False))[0]
    (args, _), = calls["flash_gat_bwd_cuda"]
    args = det(args)
    out["ms"]["gat_bwd"] = time_ms(lambda: gf.flash_gat_bwd_cuda(*args))
    out["bound_ms"]["gat_bwd"] = _gat_bwd_bound(args[0], args[1],
                                                args[3])[0]
    (args, _), = calls["fused_gat_logits_cuda"]
    args = det(args)
    out["ms"]["gat_logits_fwd"] = time_ms(
        lambda: gl.fused_gat_logits_cuda(*args))
    out["bound_ms"]["gat_logits_fwd"] = _logits_fwd_bound(args[:5])[0]
    (args, _), = calls["fused_gat_logits_bwd_cuda"]
    args = det(args)
    out["ms"]["gat_logits_bwd"] = time_ms(
        lambda: gl.fused_gat_logits_bwd_cuda(*args))
    out["bound_ms"]["gat_logits_bwd"] = _logits_bwd_bound(args[:5],
                                                          args[5])[0]
    out["plain_ms"] = _plain_ms_of_calls(calls)
    return out


def _sp_check_targets(r: dict) -> list:
    """What in a rank's ``_sp_targets`` is not its block: every split
    kernel launched, each with every source and the rank's targets, and
    the alpha residual [B, H, T_block, T]."""
    bad = []
    S = (MODEL_PARAMS["img_size"] // 8) ** 2 * MODEL_PARAMS["codebooks"]
    for (_, name), _ in SP_SPLIT.items():
        n, (lo, hi) = ((S, r["blocks"]["pairwise"]) if "pairwise" in name
                       else (S + 1, r["blocks"]["gat"]))
        calls = r["targets"].get(name, [])
        if not calls or any(c != (n, hi - lo) for c in calls):
            bad.append((name, calls))
    lo, hi = r["blocks"]["gat"]
    if not r["targets"]["alpha"] or any(
            a[2:] != [hi - lo, S + 1] for a in r["targets"]["alpha"]):
        bad.append(("alpha", r["targets"]["alpha"]))
    return bad


def phase_sp(smi: str) -> tuple:
    """Sequence parallelism of the headline model (configs/ct_mcq_vae.yaml
    at full width, ``ct_layer`` trained, cuDNN's deterministic
    algorithms) on two gloo ranks sharing the card, at (data 1, model 2):
    ``_sp_rank``, spawned after the kernels are built, joined within
    SP_TIMEOUT seconds or killed. A correctness path: both ranks share one
    card, so its times are no scaling figure. The launch counters of the
    SP steps and requests (at float32 and bfloat16) are the path "sp".
    Then the path "fsdp_tp" (``_fsdp_tp_path``). Returns (the launches
    of "sp", those of "fsdp_tp", the numbers)."""
    import torch.multiprocessing as mp
    start = time.perf_counter()
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    with tempfile.TemporaryDirectory(prefix="ctvae_sp_") as tmp:
        ctx = mp.start_processes(_sp_rank, args=(_free_port(), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + SP_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline
                                           - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"sp: the ranks ran past "
                                         f"{SP_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        r0, r1 = (torch.load(os.path.join(tmp, f"sp_rank{r}.pt"),
                             weights_only=False) for r in range(2))
    for r in (r0, r1):
        if "error" in r:
            raise AssertionError(f"sp rank {r['rank']}:\n{r['error']}")
        _add_counts(launches, {k: 0 for k in launches}, r["launches"])
    s0, s1 = r0["steps"], r1["steps"]
    numbers = {
        "rank_ms": s0["ms"], "rank1_ms": s1["ms"],
        "worst_loss_diff": s0["worst_loss_rel"],
        "worst_grad_err": s0["worst_grad"], "peak_bytes": {
            mode: {"rank0": s0["peak"][mode]["sp"],
                   "rank1": s1["peak"][mode]["sp"],
                   "one_process": s0["peak"][mode]["single"]}
            for mode in EXPECTED_TRAIN},
        "collective_bytes": {mode: {k: v for k, v in s0["bytes"][mode].items()
                                    if k.endswith("_bytes")}
                             for mode in EXPECTED_TRAIN},
        "targets": {str(r["rank"]): {k: sorted(set(map(tuple, v)))
                                     for k, v in r["targets"].items()}
                    for r in (r0, r1)},
        "requests": {k: v for k, v in r0["requests"].items()
                     if k != "wrong"},
        "bf16": {k: r0["bf16"][k] for k in ("loss_max_rel", "worst_ratio",
                                            "beyond")},
        "times": {str(r["rank"]): r["times"] for r in (r0, r1)},
        "vq": {str(r["rank"]): r["vq"] for r in (r0, r1)},
        "on_step_max_abs_err": {
            str(r["rank"]): {
                "pairwise_fwd": max(m["max_abs_err"] for m in
                                    r["on_step"]["pairwise_fwd"].values()),
                "gat_fwd": r["on_step"]["gat_fwd"]["max_abs_err"],
                "gat_logits_fwd": r["on_step"]["logits"]["fwd"][
                    "max_abs_err"],
                "pairwise_bwd": max(m["err"] for m in
                                    r["on_step"]["pairwise_bwd"].values()),
                "gat_bwd": r["on_step"]["gat_bwd"]["errors"],
                "gat_logits_bwd": r["on_step"]["logits"]["bwd"]["errors"],
                "vq_differ": [v["differ"] for v in r["vq"]]}
            for r in (r0, r1)}}
    log(f"sp two ranks on one card over gloo at (data 1, model 2) ({smi}), "
        f"a correctness path (both ranks share the card; no scaling "
        f"figure): ms per step at B = 16, rank 0 {json.dumps(s0['ms'])}, "
        f"rank 1 {json.dumps(s1['ms'])}; {SP_STEPS} steps a mode against "
        f"one process from equal states: worst metric difference over "
        f"1 + |one process's| {s0['worst_loss_rel']:.3g}, worst gradient "
        f"error over its leaf's scale {s0['worst_grad']:.3g} (bound "
        f"{SP_TOL}); metrics off "
        f"{s0['metrics_off']}, gradients off {s0['grads_off']}, parameters "
        f"beyond Adam's reach {s0['params_off']}; launches per step off the "
        f"plain step's {s0['wrong'] + s1['wrong']}")
    log(f"sp peak bytes of one step (above what was allocated before it): "
        f"{json.dumps(numbers['peak_bytes'])}")
    log(f"sp collective bytes of one step on a rank: "
        f"{json.dumps(numbers['collective_bytes'])}; causal gathers "
        f"{json.dumps(s0['bytes']['causal']['gathers'])}, sums "
        f"{json.dumps(s0['bytes']['causal']['sums'])}")
    log(f"sp targets per split launch (sources, targets): "
        f"{json.dumps(numbers['targets'])}")
    log(f"sp requests under model_parallel against one process: "
        f"{json.dumps(numbers['requests'])}")
    for r in (r0, r1):
        log(f"sp rank {r['rank']} block calls of a causal step, each rank "
            f"alone on the card ({smi}): kernel ms "
            f"{json.dumps(r['times']['ms'])}, bound ms "
            f"{json.dumps(r['times']['bound_ms'])}, plain ms "
            f"{json.dumps(r['times']['plain_ms'])}; VQ search (unsplit, "
            f"timed beside the other rank) {json.dumps(r['vq'])}")
    log(f"sp bf16 causal: {SP_BF16_STEPS} steps, losses' largest relative "
        f"difference {r0['bf16']['loss_max_rel']:.3g}, the largest gradient "
        f"distance over its bound {r0['bf16']['worst_ratio']:.3g} (beyond: "
        f"{r0['bf16']['beyond']})")
    bad = _sp_check_targets(r0) + _sp_check_targets(r1)
    if bad:
        raise AssertionError(f"sp: kernels off the rank's block: {bad}")
    if s0["metrics_off"] or s0["grads_off"] or s0["params_off"] or \
            s0["wrong"] or s1["wrong"]:
        raise AssertionError("sp two ranks: disagree with one process")
    req = r0["requests"]
    if req["wrong"] or r1["requests"]["wrong"] or \
            req["classify_action"]["max_abs_err"] > SP_REQUEST_ATOL or \
            max(req[n]["differ_share"] for n in ("reconstruct",
                                                  "apply_action")) > 0.01:
        raise AssertionError(f"sp requests: {req}, rank 1 "
                             f"{r1['requests']}")
    if r0["bf16"]["loss_max_rel"] > 5 * BF16_ULP or r0["bf16"]["beyond"] \
            or r0["bf16"]["wrong"] or r1["bf16"]["wrong"]:
        raise AssertionError(f"sp bf16: {r0['bf16']}")
    log(f"launches on the sp path: {json.dumps(launches)}")
    tp_launches, numbers["fsdp_tp"] = walled("fsdp_tp", _fsdp_tp_path, smi)
    numbers["wall_s"] = time.perf_counter() - start
    log(f"sp: phase {numbers['wall_s']:.1f} s")
    return launches, tp_launches, numbers


# --- path "fsdp_tp": FSDP with a model axis, in phase "sp" ----------------

TP_STEPS = 8          # steps of each mode on the two ranks and in one process
TP_BF16_STEPS = 3     # causal steps at bfloat16
TP_SCAN_K = 4         # the scan_steps of run.train at world 2
TP_SCAN_LIMIT = 80    # TSynthetic rows a mode: 15 batches of 16, a run of 4
TP_TIMEOUT = 300      # seconds for the two rank processes


def _tp_state(params, bg, mg, data_group):
    """The headline model of ``params`` and the config's exp_params under
    ``sharding: fsdp`` over a mesh (data 1, model 2): rank 0's weights and
    generator (a broadcast over the world), the leaves of JAX's
    tensor-parallel rules split over the model group ``mg``
    (``fully_shard`` at the default ``fsdp_min_size``), the optimizers
    over the blocks."""
    from ctvae_torch.models import build_model
    from ctvae_torch.parallel import fully_shard, put_replicated
    from ctvae_torch.training import build_optimizers, create_train_state
    model = build_model(params, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    state = create_train_state(model, [], seed=SEED, group=bg,
                               model_group=mg)
    put_replicated(model, torch.distributed.group.WORLD, state.generator)
    state.fsdp = fully_shard(model, data_group, model_group=mg)
    state.optimizers = build_optimizers(EXP_PARAMS, model,
                                        steps_per_epoch=100, fsdp=state.fsdp)
    return state


def _tp_steps(tp, single, launches: dict) -> dict:
    """TP_STEPS steps of each mode on the rank (the same B = 16 rows on
    both: a data axis of 1); before each, the gathered state (a
    collective) goes into one process on rank 0, which takes the step
    beside it. Per mode the step's ms; the launches per step against the
    plain step's; the losses and every parameter's gathered gradient
    against one process to tier-1's bound, the parameters within Adam's
    reach of the gradients' difference."""
    from ctvae_torch.training import make_train_step
    lr = float(EXP_PARAMS["LR"])
    out = {"wrong": [], "metrics_off": [], "grads_off": [],
           "params_off": [], "worst_grad": 0.0, "worst_loss_rel": 0.0,
           "param_max_diff": 0.0, "ms": {}}
    for i, (mode, expected) in enumerate(EXPECTED_TRAIN.items()):
        step = make_train_step(mode)
        secs = []
        for b in _ddp_batches(SEED + 91 + i, TP_STEPS, BATCH):
            full = copy.deepcopy(tp.state_dict())
            if single is not None:
                single.load_state_dict(full)
            del full
            c0 = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = step(tp, b)
            torch.cuda.synchronize()
            secs.append(1e3 * (time.perf_counter() - t0))
            c1 = _counts()
            _add_counts(launches, c0, c1)
            if {k: c1[k] - c0[k] for k in c1} != expected:
                out["wrong"].append(mode)
            grads, params = _full_grads_params(tp)
            if single is None:
                continue
            want = step(single, b)
            for key, w in want.items():
                g, w = got[key].double(), w.double()
                off = float(((g - w).abs() / (1 + w.abs())).max())
                out["worst_loss_rel"] = max(out["worst_loss_rel"], off)
                if off > SP_TOL:
                    out["metrics_off"].append((mode, key, off))
            for n, q in single.model.named_parameters():
                gq = q.grad if q.grad is not None else torch.zeros_like(q)
                gp = grads.get(n, torch.zeros_like(q))
                diff = (gp - gq).abs()
                err = float(diff.max()) / max(1.0, float(gq.abs().max()))
                out["worst_grad"] = max(out["worst_grad"], err)
                if err > SP_TOL:
                    out["grads_off"].append((mode, n))
                d = (params[n] - q.detach()).abs()
                out["param_max_diff"] = max(out["param_max_diff"],
                                            float(d.max()))
                if not bool((d <= _adam_reach(diff, lr)).all()):
                    out["params_off"].append((mode, n))
        out["ms"][mode] = statistics.median(secs[1:])
    return out


def _tp_bf16(bg, mg, data_group, rank: int, launches: dict) -> dict:
    """TP_BF16_STEPS causal steps at bfloat16 under FSDP with the model
    axis; before each, rank 0 loads the gathered state into one bfloat16
    process and one float32 process (the same values), which take the
    step beside it: the losses within 5 bfloat16 ulps of the bfloat16
    process's, and tier-1's rule: each gathered gradient within twice the
    bfloat16 process's distance to the float32 one plus 2 bfloat16 ulps
    of its norm."""
    from ctvae_torch.training import make_train_step
    bf = _tp_state(BF16_MODEL_PARAMS, bg, mg, data_group)
    single = _sp_state(BF16_MODEL_PARAMS) if rank == 0 else None
    twin = _sp_state(MODEL_PARAMS) if rank == 0 else None
    step = make_train_step("causal")
    out = {"loss_max_rel": 0.0, "worst_ratio": 0.0, "beyond": [],
           "wrong": [], "block_dtypes": sorted({
               str(t.dtype) for t in bf.fsdp.shards.values()})}
    for b in _ddp_batches(SEED + 83, TP_BF16_STEPS, BATCH):
        full = copy.deepcopy(bf.state_dict())
        if single is not None:
            single.load_state_dict(full)
            twin.model.load_state_dict(
                {k: v.float() if v.is_floating_point() else v
                 for k, v in full["model"].items()})
            twin.generator.set_state(full["generator"])
        del full
        c0 = _counts()
        got = step(bf, b)
        c1 = _counts()
        _add_counts(launches, c0, c1)
        if {k: c1[k] - c0[k] for k in c1} != EXPECTED_TRAIN["causal"]:
            out["wrong"].append("causal")
        grads, _ = _full_grads_params(bf)
        if single is None:
            continue
        want = step(single, b)
        step(twin, b)
        out["loss_max_rel"] = max(out["loss_max_rel"], abs(
            float(got["loss"]) - float(want["loss"])) / max(
            abs(float(want["loss"])), 1e-30))
        ref = dict(twin.model.named_parameters())
        for n, q in single.model.named_parameters():
            zero = torch.zeros(q.shape, dtype=torch.float64, device="cuda")
            g = grads[n].double() if n in grads else zero
            o = q.grad.double() if q.grad is not None else zero
            r = ref[n].grad.double() if ref[n].grad is not None else zero
            bound = 2 * float((o - r).norm()) + 2 * BF16_ULP * float(
                r.norm())
            e = float((g - r).norm())
            out["worst_ratio"] = max(out["worst_ratio"],
                                     e / bound if bound else 0.0)
            if e > bound:
                out["beyond"].append(n)
    return out


def _tp_loop_config(root: str, sharding: str) -> dict:
    """The loop config with ``scan_steps`` TP_SCAN_K over TP_SCAN_LIMIT
    TSynthetic rows a mode (a run of four base batches): ``sharding:
    fsdp`` with ``model_axis: 2``, or ``dp`` for one process."""
    cfg = _ddp_loop_config(root, 1, sharding=sharding)
    cfg["data_params"]["limit"] = TP_SCAN_LIMIT
    cfg["exp_params"]["scan_steps"] = TP_SCAN_K
    if sharding == "fsdp":
        cfg["exp_params"]["model_axis"] = 2
    return cfg


def _scan_run(cfg: dict) -> dict:
    """``run.train`` of ``cfg`` on the card: its result, each multi-step
    call's ``graphed``, the launches, the seconds."""
    from ctvae_torch import run
    from ctvae_torch.training.state import MultiTrainStep
    graphed = []
    real = MultiTrainStep.__call__

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        graphed.append(self.graphed)
        return out
    MultiTrainStep.__call__ = spy
    c0 = _counts()
    t0 = time.perf_counter()
    try:
        out = run.train(cfg, device="cuda:0")
    finally:
        MultiTrainStep.__call__ = real
    c1 = _counts()
    return {"out": out, "graphed": graphed, "s": time.perf_counter() - t0,
            "launches": {k: c1[k] - c0[k] for k in c1}}


def _tp_rank(rank: int, port: int, out_dir: str) -> None:
    """A rank of the path "fsdp_tp": two ranks over gloo sharing cuda:0,
    one mesh (data 1, model 2), the headline at full width under
    ``sharding: fsdp`` with the tensor-parallel rules: ``_tp_steps``, the
    resident bytes, each kernel call of a causal step held against its
    plain version (``_kernels_on_step``, ``_vq_on_path``), ``run.train``
    with ``scan_steps`` TP_SCAN_K (``_scan_run``), ``_tp_bf16``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from ctvae_torch.parallel import (destroy, init_distributed, make_mesh,
                                      mesh_batch_group, mesh_data_group,
                                      mesh_model_group)
    from ctvae_torch.training import make_train_step
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    res: dict = {"rank": rank, "launches": launches}
    try:
        init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2)
        mesh = make_mesh(2)
        bg, mg = mesh_batch_group(mesh), mesh_model_group(mesh)
        dg = mesh_data_group(mesh)
        tp = _tp_state(MODEL_PARAMS, bg, mg, dg)
        single = _sp_state(MODEL_PARAMS) if rank == 0 else None
        res["plan"] = {k: list(v) for k, v in tp.fsdp.plan.items()}
        res["block_shapes"] = {k: list(v.shape)
                               for k, v in tp.fsdp.shards.items()}
        res["steps"] = _tp_steps(tp, single, launches)
        res["resident_bytes"] = _resident_bytes(tp)
        if single is not None:
            res["one_process_bytes"] = _resident_bytes(single)
        b = _ddp_batches(SEED + 97, 1, BATCH)[0]
        causal = make_train_step("causal")
        res["on_step"] = _kernels_on_step(
            f"fsdp_tp rank {rank} causal step", lambda: causal(tp, b))
        res["vq"] = _vq_on_path(lambda: causal(tp, b))
        del tp, single
        torch.cuda.empty_cache()
        res["scan"] = _scan_run(_tp_loop_config(
            os.path.join(out_dir, "logs_tp"), "fsdp"))
        _add_counts(launches, {k: 0 for k in launches},
                    res["scan"]["launches"])
        torch.cuda.empty_cache()
        res["bf16"] = _tp_bf16(bg, mg, dg, rank, launches)
    except Exception:       # reported to the parent, which fails the phase
        import traceback
        res["error"] = traceback.format_exc()
    finally:
        destroy()
        torch.save(res, os.path.join(out_dir, f"tp_rank{rank}.pt"))


def _fsdp_tp_path(smi: str) -> tuple:
    """The path "fsdp_tp" of phase "sp": ``_tp_rank`` on two gloo ranks
    sharing the card, spawned after the kernels are built, joined within
    TP_TIMEOUT seconds or killed; then, in this process, ``run.train`` of
    the same loop config in one process (``sharding: dp``, its
    ``scan_steps`` block replayed from a CUDA graph) against rank 0's
    checkpoint. A correctness path: both ranks share one card, so its
    times are no scaling figure. Returns (the ranks' launches, the
    numbers)."""
    import torch.multiprocessing as mp
    from ctvae_torch.utils.checkpoint import _load
    start = time.perf_counter()
    launches = {k: 0 for k in EXPECTED_TRAIN["base"]}
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="ctvae_tp_") as tmp:
        ctx = mp.start_processes(_tp_rank, args=(_free_port(), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TP_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline
                                           - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"fsdp_tp: the ranks ran past "
                                         f"{TP_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        r0, r1 = (torch.load(os.path.join(tmp, f"tp_rank{r}.pt"),
                             weights_only=False) for r in range(2))
        for r in (r0, r1):
            if "error" in r:
                raise AssertionError(f"fsdp_tp rank {r['rank']}:\n"
                                     f"{r['error']}")
            _add_counts(launches, {k: 0 for k in launches}, r["launches"])
        tp_last = _load(os.path.join(tmp, "logs_tp", "fsdp", "version_0",
                                     "checkpoints", "last"))
        torch.backends.cudnn.deterministic = True
        try:
            one = _scan_run(_tp_loop_config(os.path.join(tmp, "logs_one"),
                                            "dp"))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        one_last = _load(os.path.join(tmp, "logs_one", "ddp", "version_0",
                                      "checkpoints", "last"))
    s0, s1 = r0["steps"], r1["steps"]
    scan_diff = {n: float((t.double() - one_last["model"][n].double())
                          .abs().max())
                 for n, t in tp_last["model"].items()
                 if t.is_floating_point()}
    scan = {"graphed": {"rank0": r0["scan"]["graphed"],
                        "rank1": r1["scan"]["graphed"],
                        "one_process": one["graphed"]},
            "multi_calls": len(r0["scan"]["graphed"]),
            "val_loss": {"rank0": r0["scan"]["out"]["val_loss"],
                         "rank1": r1["scan"]["out"]["val_loss"],
                         "one_process": one["out"]["val_loss"]},
            "steps": {"ranks": tp_last["step"],
                      "one_process": one_last["step"]},
            "param_max_diff": max(scan_diff.values()),
            "params_bit_equal": sum(d == 0.0 for d in scan_diff.values()),
            "params": len(scan_diff),
            "s": {"rank0": r0["scan"]["s"], "one_process": one["s"]}}
    on = {str(r["rank"]): {
        "pairwise_fwd": max(m["max_abs_err"] for m in
                            r["on_step"]["pairwise_fwd"].values()),
        "gat_fwd": r["on_step"]["gat_fwd"]["max_abs_err"],
        "gat_logits_fwd": r["on_step"]["logits"]["fwd"]["max_abs_err"],
        "pairwise_bwd": max(m["err"] for m in
                            r["on_step"]["pairwise_bwd"].values()),
        "gat_bwd": r["on_step"]["gat_bwd"]["errors"],
        "gat_logits_bwd": r["on_step"]["logits"]["bwd"]["errors"],
        "vq_differ": [v["differ"] for v in r["vq"]]} for r in (r0, r1)}
    numbers = {
        "plan": r0["plan"], "block_shapes": {
            str(r["rank"]): r["block_shapes"] for r in (r0, r1)},
        "rank_ms": s0["ms"], "rank1_ms": s1["ms"],
        "worst_loss_diff": s0["worst_loss_rel"],
        "worst_grad_err": s0["worst_grad"],
        "param_max_diff": s0["param_max_diff"],
        "resident_bytes": {"rank0": r0["resident_bytes"],
                           "rank1": r1["resident_bytes"],
                           "one_process": r0["one_process_bytes"]},
        "scan": scan, "on_step_max_abs_err": on,
        "bf16": {k: r0["bf16"][k] for k in ("loss_max_rel", "worst_ratio",
                                            "beyond", "block_dtypes")}}
    log(f"fsdp_tp two ranks on one card over gloo at (data 1, model 2) "
        f"({smi}), a correctness path (both ranks share the card; no "
        f"scaling figure): split {json.dumps(numbers['plan'])}, blocks "
        f"{json.dumps(numbers['block_shapes'])}; ms per step at B = 16, "
        f"rank 0 {json.dumps(s0['ms'])}, rank 1 {json.dumps(s1['ms'])}; "
        f"{TP_STEPS} steps a mode against one process from equal states: "
        f"worst metric difference over 1 + |one process's| "
        f"{s0['worst_loss_rel']:.3g}, worst gradient error over its leaf's "
        f"scale {s0['worst_grad']:.3g} (bound {SP_TOL}), parameters' "
        f"largest difference {s0['param_max_diff']:.3g}; metrics off "
        f"{s0['metrics_off']}, gradients off {s0['grads_off']}, parameters "
        f"beyond Adam's reach {s0['params_off']}; launches per step off the "
        f"plain step's {s0['wrong'] + s1['wrong']}")
    log(f"fsdp_tp resident bytes of parameters and Adam moments between "
        f"steps: {json.dumps(numbers['resident_bytes'])}")
    log(f"fsdp_tp run.train at world 2 with scan_steps {TP_SCAN_K} "
        f"({TP_SCAN_LIMIT} TSynthetic rows a mode, B = 16): "
        f"{json.dumps(scan)}")
    log(f"fsdp_tp kernel calls of a causal step on the gathered parameters "
        f"against their plain versions: {json.dumps(on)}")
    log(f"fsdp_tp bf16 causal: {TP_BF16_STEPS} steps, losses' largest "
        f"relative difference {r0['bf16']['loss_max_rel']:.3g}, the largest "
        f"gradient distance over its bound {r0['bf16']['worst_ratio']:.3g} "
        f"(beyond: {r0['bf16']['beyond']}), blocks "
        f"{r0['bf16']['block_dtypes']}")
    split = {k for k, v in r0["plan"].items() if v[0] is not None}
    if not {"ct_layer.disc_w1l", "ct_layer.disc_w1r", "ct_layer.disc_b1",
            "vq_layer.quantizers_0.embedding"} <= split:
        raise AssertionError(f"fsdp_tp: split over model {sorted(split)}")
    if s0["metrics_off"] or s0["grads_off"] or s0["params_off"] or \
            s0["wrong"] or s1["wrong"]:
        raise AssertionError("fsdp_tp two ranks: disagree with one process")
    if not r0["resident_bytes"] == r1["resident_bytes"] < \
            r0["one_process_bytes"]:
        raise AssertionError(f"fsdp_tp resident bytes: "
                             f"{numbers['resident_bytes']}")
    if scan["multi_calls"] < 1 or any(scan["graphed"]["rank0"] +
                                      scan["graphed"]["rank1"]) or \
            not any(scan["graphed"]["one_process"]) or \
            scan["steps"]["ranks"] != scan["steps"]["one_process"] or \
            scan["param_max_diff"] > DDP_ATOL or abs(
                scan["val_loss"]["rank0"] - scan["val_loss"]["one_process"]
            ) > DDP_RTOL * abs(scan["val_loss"]["one_process"]) or \
            scan["val_loss"]["rank0"] != scan["val_loss"]["rank1"]:
        raise AssertionError(f"fsdp_tp run.train with scan_steps: {scan}")
    if r0["bf16"]["loss_max_rel"] > 5 * BF16_ULP or r0["bf16"]["beyond"] \
            or r0["bf16"]["wrong"] or r1["bf16"]["wrong"]:
        raise AssertionError(f"fsdp_tp bf16: {r0['bf16']}")
    numbers["wall_s"] = time.perf_counter() - start
    log(f"launches on the fsdp_tp path: {json.dumps(launches)}")
    log(f"fsdp_tp: path {numbers['wall_s']:.1f} s")
    return launches, numbers


# --- phase "bf16": the compute dtype bfloat16 ------------------------------

# the headline config at the JAX bench's dtype (its bench runs bfloat16 in
# every tier)
BF16_MODEL_PARAMS = {**MODEL_PARAMS, "dtype": "bfloat16"}
BF16_ULP = 2.0 ** -8    # one bfloat16 ulp, relative
# a bfloat16 output of a kernel and of its plain version: the same float32
# value up to the order of its sums, rounded once: within 2 ulps of each
# element plus this share of the output's scale, max(1, max |want|)
BF16_RTOL = 1e-5
BF16_ROUNDS = 3         # timed rounds of float32 and bfloat16, in turns
BF16_REQUESTS = 4       # requests per entry point on the path
# the zoo's configs of the slice, a few steps each at bfloat16, B = 64
BF16_ZOO = {"mcq_vae": {"vq_l2_argmin": 4}, "vae": {}}
BF16_ZOO_STEPS = 4
#: the rest of the registry at bfloat16, each from its YAML (dfc_vae with
#: allow_random_features, as phase "gaussian" sets it; cvae with random
#: 0 / 1 labels), and TwoStageVAE at vae.yaml's widths at each
#: train_stage (_two_stage): BF16_ZOO_STEPS steps each on the path, none
#: launching a kernel
BF16_ZOO_MORE = (ZOO_CONFIGS + ZOO_MORE + ZOO_LAST
                 + ("cvae", "two_stage_1", "two_stage_2"))
#: the configs whose steps may turn non-finite, from the step given, as
#: the float32 ones may (DIVERGE_IN_STEPS; gammavae's epoch at its seed,
#: DIVERGE_IN_EPOCHS), under the same _NonfiniteWatch
BF16_DIVERGE = {**DIVERGE_IN_STEPS, "gammavae": DIVERGE_IN_EPOCHS["gammavae"]}
BF16_ZOO_CPU_B = 2      # the batch of a first step on the card vs the CPU


def _bf16_err(got, want) -> float:
    """How far ``got`` is past 2 bfloat16 ulps of ``want``, elementwise,
    over max(1, max |want|): 0 where every element is within 2 ulps."""
    g, w = got.detach().float(), want.detach().float()
    scale = max(1.0, float(w.abs().max()))
    excess = float(((g - w).abs() - 2 * BF16_ULP * w.abs()).max())
    return max(0.0, excess) / scale


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def _bf16_cases():
    """Per kernel: (the wrapper module, its ``*_cuda`` launch, how its
    captured arguments become the op's and the plain version's on the
    card, and the operations the bound counts on them; see the f32 rows'
    bound functions for what each count holds)."""
    from ctvae_torch.ops import gat_flash as gf
    from ctvae_torch.ops import gat_logits as gl
    from ctvae_torch.ops import library
    from ctvae_torch.ops import pairwise_flash as pf
    from ctvae_torch.ops.gat import gat_logits
    from ctvae_torch.ops.pairwise import fused_pairwise_scores, pairwise_logits

    def pw_b2(w2, xl):
        return xl.new_zeros((xl.shape[0],) if w2.dim() == 2 else ())

    def pw_bwd_op(a, kw):
        xl, xr, w2, b1, out, dout, ns = a
        return (xl, xr, w2, b1, pw_b2(w2, xl), out, dout, ns)

    def pw_bwd_plain(xl, xr, w2, b1, b2, out, dout, ns):
        out32 = out.float()
        dz = dout.float() * (1 - out32) * out32
        return library._plain_vjp(pairwise_logits, (xl, xr, w2, b1, b2), dz,
                                  ns)

    def pw_fwd_ops(a):
        xl, xr = a[:2]
        B, S, H = xl.shape
        T = xr.shape[1]
        return 4.0 * B * S * T * H + 2.0 * B * S * H + 3.0 * B * T * H \
            + 8.0 * B * S * T

    def pw_bwd_ops(a):
        xl, xr, w2, b1, b2, out, dout, _ = a
        B, S, H = xl.shape
        T = xr.shape[1]
        live = int((dout.float() * out.float() * (1 - out.float()) != 0)
                   .sum())
        return 5.0 * live * H + 3.0 * B * (S + T + 1) * H + 4.0 * B * S * T

    def gat_plain_fwd(xl, xr, adj, mask, we, att, ns):
        out, alpha = gf.plain_gat(xl, xr, adj, mask, we, att, ns)
        return out, alpha.permute(0, 3, 2, 1)

    def gat_bwd_plain(xl, xr, adj, mask, we, att, alpha, dout, ns):
        return library._plain_vjp(
            lambda xl, xr, adj, we, att: gf.flash_gat_plain(
                xl, xr, adj, mask, we, att, ns), (xl, xr, adj, we, att),
            dout)

    def logits_bwd_plain(xl, xr, adj, we, att, d_e, ns):
        dxl, dxr, dadj, dwe, datt = library._plain_vjp(
            gat_logits, (xl, xr, adj, we, att), d_e, ns)
        return dxl, dxr, dadj, torch.stack((dwe, datt), -3)

    def edges_hf(a):
        xl, mask = a[0], a[3]
        return float(int(mask.sum())) * xl.shape[2] * xl.shape[3]

    return {
        "pairwise_fwd": (pf, "flash_pairwise_cuda", "pairwise_fwd",
                         lambda a, kw: a, fused_pairwise_scores, pw_fwd_ops),
        "pairwise_bwd": (pf, "flash_pairwise_bwd_cuda", "pairwise_bwd",
                         pw_bwd_op, pw_bwd_plain, pw_bwd_ops),
        "gat_fwd": (gf, "flash_gat_cuda", "gat_fwd_alpha",
                    lambda a, kw: a, gat_plain_fwd,
                    lambda a: 9.0 * edges_hf(a)),
        "gat_bwd": (gf, "flash_gat_bwd_cuda", "gat_bwd", lambda a, kw: a,
                    gat_bwd_plain, lambda a: 17.0 * edges_hf(a)),
        "gat_logits_fwd": (gl, "fused_gat_logits_cuda", "gat_logits_fwd",
                           lambda a, kw: a, gat_logits,
                           lambda a: 5.0 * a[0].shape[0] * a[0].shape[1]
                           * a[1].shape[1] * a[0].shape[2] * a[0].shape[3]),
        "gat_logits_bwd": (gl, "fused_gat_logits_bwd_cuda", "gat_logits_bwd",
                           lambda a, kw: a, logits_bwd_plain,
                           lambda a: 10.0 * int((a[5] != 0).sum())
                           * a[0].shape[3]),
    }


def _bf16_kernels_on_step(label: str, fn, timed: bool) -> dict:
    """Every kernel call of one call of ``fn`` (a bfloat16 train step):
    its op on the card (the bfloat16 instantiation) against the plain
    version at bfloat16 on the same inputs on the card, within 2 ulps of
    each element plus BF16_RTOL of each output's scale, and a rerun bit
    for bit; the VQ search (float32: the latents upcast first) against
    the plain search, indices equal but on near-ties. With ``timed``, the
    kernel's, its float32 instantiation's (on the same values upcast) and
    the plain version's ms on those inputs and the bound (bytes at each
    tensor's element size, float32 operations). The counters are put back
    after."""
    from ctvae_torch.ops import set_launch_counts
    from ctvae_torch.ops import vq
    from ctvae_torch.ops.common import custom_ops
    cases = _bf16_cases()
    targets = [(vq, "l2_argmin_cuda")] + [(c[0], c[1])
                                         for c in cases.values()]
    saved = _counts()
    calls = _all_calls(fn, targets)
    out = {"vq_l2_argmin": []}
    for args, _ in calls["l2_argmin_cuda"]:
        x, cb = (a.detach() for a in args[:2])
        got = vq.l2_argmin_cuda(x, cb)
        differ, ties, gap = _vq_agreement(x, cb, got)
        out["vq_l2_argmin"].append({"x": list(x.shape), "dtype": str(x.dtype),
                                    "differ": differ, "near_ties": ties})
        if differ != ties or x.dtype != torch.float32:
            raise AssertionError(f"bf16 {label}: vq {out['vq_l2_argmin']}")
    for name, (module, fn_name, op_name, op_args, plain, n_ops) in \
            cases.items():
        op = getattr(custom_ops(), op_name)
        rows = out[name] = []
        for args, kw in calls[fn_name]:
            a = op_args(tuple(x.detach() if torch.is_tensor(x) else x
                              for x in args), kw)
            if a[0].dtype != torch.bfloat16:
                raise AssertionError(f"bf16 {label}: {name} got {a[0].dtype}")
            got = op(*a)
            again = op(*a)
            with torch.no_grad():
                want = plain(*a)
            got, want, again = (
                (t,) if torch.is_tensor(t) else tuple(t)
                for t in (got, want, again))
            dtypes = [str(g.dtype).replace("torch.", "") for g in got]
            if [g.dtype for g in got] != [w.dtype for w in want]:
                raise AssertionError(f"bf16 {label}: {name} dtypes {dtypes} "
                                     f"against {[w.dtype for w in want]}")
            errs = [_bf16_err(g, w) for g, w in zip(got, want)]
            same = all(torch.equal(g, h) for g, h in zip(got, again))
            row = {"shape": list(a[0].shape), "dtypes": dtypes,
                   "errors": [float(f"{e:.3g}") for e in errs],
                   "bit_identical": same}
            if timed:
                launch = getattr(module, fn_name)
                row["ms"] = time_ms(lambda: launch(*args, **kw), reps=11)
                # the float32 instantiation on the same values
                args32 = tuple(x.detach().float() if torch.is_tensor(x)
                               and x.dtype == torch.bfloat16 else x
                               for x in args)
                row["f32_ms"] = time_ms(lambda: launch(*args32, **kw),
                                        reps=11)
                with torch.no_grad():
                    row["plain_ms"] = time_ms(lambda: plain(*a), reps=3)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    _nbytes(a) + _nbytes(got), n_ops(a))
            rows.append(row)
            log(f"bf16 {label}: {name} {json.dumps(row)}")
            if max(errs) > BF16_RTOL or not same:
                raise AssertionError(f"bf16 {label}: {name} disagrees with "
                                     f"its plain version: {row}")
            del got, want, again
    del calls
    set_launch_counts(saved)
    torch.cuda.empty_cache()
    return out


def _bf16_states(params, B: int, dtypes=("bfloat16",), seed: int = SEED,
                 exp=EXP_PARAMS):
    """One train state per dtype of ``params`` (equal weights: the float32
    model's cast where a parameter is bfloat16) and a batch of ``B``."""
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state
    states = {}
    for dt in dtypes:
        model = build_model({**params, "dtype": dt}, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                seed))
        states[dt] = create_train_state(
            model, build_optimizers(exp, model, steps_per_epoch=100),
            seed=seed)
    return states


def _bf16_zoo(launches: dict) -> tuple:
    """MCQVAE and VanillaVAE from their YAML at bfloat16 (full width, B =
    64): BF16_ZOO_STEPS steps each, every step's launches as expected
    (the VQ search per codebook; none for VanillaVAE) and a finite loss;
    BatchNorm's statistics float32. Then each of BF16_ZOO_MORE at
    bfloat16 (``_bf16_zoo_member``). Adds the steps' launches to
    ``launches``. Returns (the numbers, how each member is built)."""
    from ctvae_torch.training import make_train_step
    out = {}
    root = os.path.dirname(CONFIG)
    for name, expected in BF16_ZOO.items():
        cfg = read_config(os.path.join(root, f"{name}.yaml"))
        p = {**cfg["model_params"], "dtype": "bfloat16"}
        state = _bf16_states(p, 64, exp=cfg["exp_params"])["bfloat16"]
        if state.model.compute_dtype != torch.bfloat16:
            raise AssertionError(f"bf16 {name}: {state.model.compute_dtype}")
        size = p.get("img_size", 64)
        x = torch.rand(64, size, size, p.get("in_channels", 3),
                       generator=torch.Generator("cuda").manual_seed(SEED),
                       device="cuda")
        step = make_train_step("base",
                               M_N=cfg["exp_params"].get("kld_weight", 1.0))
        losses = []
        for _ in range(BF16_ZOO_STEPS):
            c0 = _counts()
            metrics = step(state, {"image": x})
            c1 = _counts()
            got = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
            if got != expected:
                raise AssertionError(f"bf16 {name}: launches per step {got}"
                                     f", expected {expected}")
            for k, n in got.items():
                launches[k] += n
            losses.append(float(metrics["loss"]))
        buffers = {str(b.dtype) for b in state.model.buffers()}
        if not all(math.isfinite(v) for v in losses) or \
                buffers - {"torch.float32"}:
            raise AssertionError(f"bf16 {name}: losses {losses}, buffers "
                                 f"{buffers}")
        out[name] = {"losses": losses, "buffer_dtypes": sorted(buffers)}
        log(f"bf16 {name}.yaml at bfloat16, B=64: {BF16_ZOO_STEPS} steps, "
            f"losses {json.dumps([round(v, 6) for v in losses])}")
        del state
    members = {}
    for name in BF16_ZOO_MORE:
        members[name] = _bf16_member(name)
        out[name] = _bf16_zoo_member(name, members[name])
    return out, members


def _bf16_member(name: str) -> dict:
    """How BF16_ZOO_MORE's ``name`` is built: ``build(dtype, device,
    generator)``, its exp_params as run.train takes them, its M_N, and
    ``batch(B, generator)`` on the card."""
    from ctvae_torch.models import build_model
    root = os.path.dirname(CONFIG)
    if name.startswith("two_stage_"):
        cfg = read_config(os.path.join(root, "vae.yaml"))
        mp = cfg["model_params"]

        def build(dtype, device, gen):
            return _two_stage(int(name[-1]), gen, dtype, device)
    else:
        cfg = read_config(os.path.join(root, f"{name}.yaml"))
        mp = {**cfg["model_params"], **(
            {"allow_random_features": True} if name == "dfc_vae" else {})}

        def build(dtype, device, gen):
            return build_model({**mp, "dtype": dtype}, device=device,
                               generator=gen)
    size, ch = mp.get("img_size", 64), mp.get("in_channels", 3)

    def batch(B, gen):
        b = {"image": torch.rand(B, size, size, ch, generator=gen,
                                 device=gen.device)}
        if name == "cvae":
            b["labels"] = torch.randint(0, 2, (B, mp["num_classes"]),
                                        generator=gen,
                                        device=gen.device).float()
        return b
    exp = _exp_params(cfg)
    return {"build": build, "exp": exp, "batch": batch,
            "M_N": float(exp.get("kld_weight", 1.0))}


def _bf16_calls(state, M_N: float) -> list:
    """One train step's calls: one per optimizer (FactorVAE's two)."""
    from ctvae_torch.training import make_train_step
    return [make_train_step("base", M_N=M_N, optimizer_idx=i)
            for i in range(len(state.optimizers))]


def _bf16_zoo_member(name: str, member: dict) -> dict:
    """BF16_ZOO_STEPS eager train steps of ``name`` at bfloat16 (B = 64),
    each launching no kernel, under a _NonfiniteWatch (finite, or
    non-finite from BF16_DIVERGE's step on as on the CPU from the same
    state); ``compute_dtype`` bfloat16, every parameter and buffer (the
    frozen VGG's too) float32."""
    from ctvae_torch.training import build_optimizers, create_train_state
    model = member["build"]("bfloat16", "cuda",
                            torch.Generator("cuda").manual_seed(SEED))
    dtypes = ({str(p.dtype) for p in model.parameters()}
              | {str(b.dtype) for b in model.buffers()})
    if model.compute_dtype != torch.bfloat16 or dtypes != {"torch.float32"}:
        raise AssertionError(f"bf16 {name}: compute {model.compute_dtype}, "
                             f"parameters and buffers {dtypes}")
    state = create_train_state(model, build_optimizers(
        member["exp"], model, steps_per_epoch=100), seed=SEED)
    calls = _bf16_calls(state, member["M_N"])
    batch = member["batch"](GAUSSIAN_BATCH,
                            torch.Generator("cuda").manual_seed(SEED))
    losses = []
    with _NonfiniteWatch(f"bf16 {name}") as watch:
        for _ in range(BF16_ZOO_STEPS):
            c0 = _counts()
            for call in calls:
                metrics = call(state, batch)
            c1 = _counts()
            if c1 != c0:
                raise AssertionError(f"bf16 {name}: a step launched "
                                     f"{ {k: c1[k] - c0[k] for k in c1} }")
            losses.append(float(metrics["loss"]))
    allowed = BF16_DIVERGE.get(name)
    if watch.first is not None and (allowed is None
                                    or watch.first < allowed):
        raise AssertionError(f"bf16 {name}: non-finite from step "
                             f"{watch.first}; losses {losses}")
    log(f"bf16 {name} at bfloat16, B={GAUSSIAN_BATCH}: {BF16_ZOO_STEPS} "
        f"steps of {len(calls)} call(s), losses {json.dumps(losses)}"
        + (f", non-finite from step {watch.first} as on the CPU"
           if watch.first is not None else ""))
    return {"losses": losses, "nonfinite_from_step": watch.first,
            "dtypes": sorted(dtypes), "calls_per_step": len(calls)}


def _bf16_zoo_checks(members: dict, smi: str) -> dict:
    """Each of BF16_ZOO_MORE at bfloat16 after the path: its first train
    step at B = BF16_ZOO_CPU_B on the card against the CPU port from the
    same weights and CPU-drawn draws (each optimizer's call in turn), the
    losses within 5 ulps (2 %); then float32 against bfloat16 ms per step
    at B = 64 (every optimizer's call), in turns, medians of BF16_ROUNDS
    after a warm-up round. Returns the numbers and the part's seconds."""
    from ctvae_torch.training import build_optimizers, create_train_state
    from ctvae_torch.training import state as tstate
    start = time.perf_counter()
    out = {"card": smi}
    order = ("float32", "bfloat16")
    for name, member in members.items():
        card = member["build"]("bfloat16", "cuda",
                               torch.Generator("cuda").manual_seed(SEED))
        host = copy.deepcopy(card).to("cpu")
        b = member["batch"](BF16_ZOO_CPU_B,
                            torch.Generator().manual_seed(SEED + 3))
        res = []
        for model, dev in ((card, "cuda"), (host, "cpu")):
            state = create_train_state(model, build_optimizers(
                member["exp"], model, steps_per_epoch=100), seed=SEED)
            real = tstate.Draws
            tstate.Draws = lambda gen, device, dev=dev: _replay_draws(dev,
                                                                      SEED)
            try:
                res.append([{k: float(v) for k, v in call(state, {
                    k: t.to(dev) for k, t in b.items()}).items()
                    if k in ("loss", "Reconstruction_Loss")}
                    for call in _bf16_calls(state, member["M_N"])])
            finally:
                tstate.Draws = real
        errs = {f"{k}_{i}": abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for i, (g, w) in enumerate(zip(*res)) for k in w}
        if not max(errs.values()) <= 5 * BF16_ULP:
            raise AssertionError(f"bf16 {name} first step, card vs CPU: "
                                 f"{res} ({errs})")
        states = {}
        for dt in order:
            model = member["build"](dt, "cuda",
                                    torch.Generator("cuda").manual_seed(SEED))
            states[dt] = create_train_state(model, build_optimizers(
                member["exp"], model, steps_per_epoch=100), seed=SEED)
        calls = _bf16_calls(states["float32"], member["M_N"])
        batch = member["batch"](GAUSSIAN_BATCH,
                                torch.Generator("cuda").manual_seed(SEED))
        secs = {d: [] for d in order}
        for r in range(BF16_ROUNDS + 1):
            for d in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for call in calls:
                    call(states[d], batch)
                torch.cuda.synchronize()
                secs[d].append(1e3 * (time.perf_counter() - t0))
        ms = {d: statistics.median(v[1:]) for d, v in secs.items()}
        out[name] = {"vs_cpu": {"card": res[0], "cpu": res[1], "rel": errs},
                     "ms_per_step": ms}
        log(f"bf16 {name}: first step B={BF16_ZOO_CPU_B} card vs CPU "
            f"{json.dumps(res)}, relative {json.dumps(errs)}; ms per step "
            f"B={GAUSSIAN_BATCH} (medians of {BF16_ROUNDS} rounds in turns "
            f"after a warm-up one) {json.dumps(ms)} on {smi}")
        del card, host, states
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    log(f"bf16 zoo checks: {out['seconds']:.1f} s for "
        f"{len(members)} configs")
    return out


def _bf16_card_cpu(name: str, got, want) -> tuple:
    """(whether the card's output ``got`` of entry point ``name`` at
    bfloat16 agrees with the CPU's ``want``, its numbers): ``encode``
    within 2 ulps of each element plus 4 of its scale,
    ``classify_action``'s probabilities within 4 ulps of their scale, and
    at least 95 % of an image's pixels within 8 ulps of its scale (see
    ``_bf16_vs_cpu``)."""
    scale = max(1.0, float(want.abs().max()))
    diff = (got - want).abs()
    m = {"max_abs_err": float(diff.max()), "dtype": str(got.dtype)}
    if name == "encode":
        ok = _bf16_err(got, want) <= 4 * BF16_ULP
    elif name == "classify_action":
        ok = float(diff.max()) <= 4 * BF16_ULP * scale
    else:
        share = float((diff <= 8 * BF16_ULP * scale).float().mean())
        m["share_within_8_ulps"] = share
        ok = share >= 0.95
    return ok, m


def _bf16_vs_cpu(smi: str) -> dict:
    """The four entry points at B = 2 and one train step per mode at B = 2
    on the card against the CPU port at bfloat16, from the same weights and
    CPU-drawn draws. Card and CPU round bfloat16 in other places (cuBLAS's
    and cuDNN's sums; ``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction`` as logged), which can flip a
    decision at a near-tie (a VQ index, the argmax of the CT layer's
    output, a sampled edge) and with it a site's code: ``encode`` within 2
    ulps of each element plus 4 of its scale, ``classify_action``'s
    probabilities within 4 ulps of their scale, and at least 95 % of the
    images' pixels within 8 ulps of their scale; each step's losses within
    5 ulps (2 %)."""
    from ctvae_torch.serving.inference import make_inference_fn
    from ctvae_torch.training import make_train_step
    from ctvae_torch.training import state as tstate
    log(f"bf16: torch.backends.cuda.matmul."
        f"allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f"; cudnn.deterministic = {torch.backends.cudnn.deterministic}")
    from ctvae_torch.training import build_optimizers, create_train_state
    card_model = _bf16_states(BF16_MODEL_PARAMS, 2)["bfloat16"].model
    host_model = copy.deepcopy(card_model).to("cpu")

    def state(model):
        return create_train_state(
            model, build_optimizers(EXP_PARAMS, model, steps_per_epoch=100),
            seed=SEED)
    x, y, a = _requests(torch.Generator().manual_seed(SEED + 7), 2, "cpu")
    out = {}
    import ctvae_torch.serving.inference as inference
    real = inference._draws
    try:
        for name in ("reconstruct", "encode", "apply_action",
                     "classify_action"):
            args = {"reconstruct": (x,), "encode": (x,),
                    "apply_action": (x, y, a), "classify_action": (x, y)}[name]
            res = []
            for model, dev in ((card_model, "cuda"), (host_model, "cpu")):
                inference._draws = lambda m, g, dev=dev: _replay_draws(
                    dev, SEED)
                fn = make_inference_fn(model, name)
                res.append(fn(*(t.to(dev) for t in args)).float().cpu())
            got, want = res
            ok, m = _bf16_card_cpu(name, got, want)
            out[name] = m
            log(f"bf16 {name} B=2, card vs CPU: {json.dumps(m)}")
            if not ok:
                raise AssertionError(f"bf16 {name}: card and CPU disagree "
                                     f"{m}")
    finally:
        inference._draws = real
    b = {"image": x, "input_y": y, "action": a}
    for mode in EXPECTED_TRAIN:
        res = []
        for model, dev in ((card_model, "cuda"), (host_model, "cpu")):
            real_draws = tstate.Draws
            tstate.Draws = lambda gen, device, dev=dev: _replay_draws(dev,
                                                                      SEED)
            try:
                metrics = make_train_step(mode)(
                    state(copy.deepcopy(model)),
                    {k: v.to(dev) for k, v in b.items()})
            finally:
                tstate.Draws = real_draws
            res.append({k: float(v) for k, v in metrics.items()
                        if torch.is_tensor(v) and v.dim() == 0})
        got, want = res
        errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                for k in ("loss", "Reconstruction_Loss", "CT_Loss")}
        out[f"step_{mode}"] = {"card": got["loss"], "cpu": want["loss"],
                               "rel": errs}
        log(f"bf16 first step {mode} B=2, card vs CPU: loss {got['loss']:.6g}"
            f" / {want['loss']:.6g}, relative differences {json.dumps(errs)}")
        if max(errs.values()) > 5 * BF16_ULP:
            raise AssertionError(f"bf16 step {mode}: card and CPU disagree "
                                 f"{errs}")
    return out


def _bf16_in_turns(states, steps, batch, fns, args) -> dict:
    """Float32 against bfloat16, in turns (BF16_ROUNDS rounds): ms per
    eager train step of each mode (SCAN_K steps a round) and per request
    of each entry point (4 a round), each state stepping on its own."""
    out = {}
    order = ("float32", "bfloat16")
    for mode, step in steps.items():
        secs = {d: [] for d in order}
        for r in range(BF16_ROUNDS):
            for d in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SCAN_K):
                    step(states[d], batch)
                torch.cuda.synchronize()
                secs[d].append(1e3 * (time.perf_counter() - t0) / SCAN_K)
        out[f"step_{mode}"] = {d: statistics.median(s)
                               for d, s in secs.items()}
        log(f"bf16 vs f32 train {mode} B={BATCH}: ms per step (medians of "
            f"{BF16_ROUNDS} rounds of {SCAN_K} in turns) "
            f"{json.dumps(out[f'step_{mode}'])}; rounds {json.dumps(secs)}")
    gen = torch.Generator("cuda").manual_seed(SEED)
    for name in fns["float32"]:
        secs = {d: [] for d in order}
        for r in range(BF16_ROUNDS + 1):
            for d in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    fns[d][name](*args[name], generator=gen)
                torch.cuda.synchronize()
                secs[d].append(1e3 * (time.perf_counter() - t0) / 4)
        out[f"serve_{name}"] = {d: statistics.median(s[1:])
                                for d, s in secs.items()}
        log(f"bf16 vs f32 serve {name} B={BATCH}: ms per request (medians "
            f"of {BF16_ROUNDS} rounds after a warm-up one, in turns) "
            f"{json.dumps(out[f'serve_{name}'])}")
    return out


def phase_bf16(smi: str) -> tuple:
    """The headline config at ``dtype: bfloat16`` (B = 16, A*B = 192),
    MCQVAE and VanillaVAE from their YAML at bfloat16. The path "bf16"
    (the counters set to 0 just before and read just after): BF16_REQUESTS
    requests of each entry point at B = 16, 2 x SCAN_K eager train steps
    per mode, two ``make_multi_train_step(mode, SCAN_K)`` calls per mode
    from an equal state on the same batches (the graph's launches counted
    at capture, times its replays) and the zoo's steps (``_bf16_zoo``:
    BF16_ZOO and BF16_ZOO_MORE). Then: graph against eager steps, every
    parameter and Adam moment bit for bit (cuDNN deterministic); every
    kernel call of a base, an action and a causal step held against its
    plain version at bfloat16 (``_bf16_kernels_on_step``; timed on the
    causal step's and the action step's inputs); the zoo's first steps
    against the CPU and its ms in turns (``_bf16_zoo_checks``); the card
    against the CPU (``_bf16_vs_cpu``); float32
    against bfloat16 step and request ms, in turns (``_bf16_in_turns``).
    Returns (the path's launches, the kernels' rows, the numbers)."""
    from ctvae_torch.serving.inference import make_inference_fn
    from ctvae_torch.training import make_multi_train_step, make_train_step
    start = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = _bf16_states(MODEL_PARAMS, BATCH,
                              dtypes=("float32", "bfloat16"))
        graph = _bf16_states(MODEL_PARAMS, BATCH)["bfloat16"]
        model = states["bfloat16"].model
        kinds = {str(p.dtype) for p in model.ct_layer.parameters()}
        if model.ct_layer.disc_w1l.dtype != torch.bfloat16 or \
                model.encoder.Conv_0.weight.dtype != torch.float32:
            raise AssertionError(f"bf16: parameter dtypes {kinds}")
        fns = {d: {n: make_inference_fn(s.model, n) for n in
                   ("reconstruct", "encode", "apply_action",
                    "classify_action")} for d, s in states.items()}
        gen = torch.Generator().manual_seed(SEED + 11)
        x, y, a = _requests(gen, BATCH, "cuda")
        args = {"reconstruct": (x,), "encode": (x,),
                "apply_action": (x, y, a), "classify_action": (x, y)}
        xs = [_requests(gen, BATCH, "cuda") for _ in range(2 * SCAN_K)]
        stacked = {k: torch.stack([r[i] for r in xs])
                   for i, k in enumerate(("image", "input_y", "action"))}
        steps = {m: make_train_step(m) for m in EXPECTED_TRAIN}
        multis = {m: make_multi_train_step(m, SCAN_K) for m in EXPECTED_TRAIN}
        dgen = torch.Generator("cuda").manual_seed(SEED)
        _reset_counts()
        for name, fn in fns["bfloat16"].items():
            for _ in range(BF16_REQUESTS):
                out = fn(*args[name], generator=dgen)
            if name != "encode":
                _check_served(name, out.float(), BATCH)
            elif out.dtype != torch.bfloat16:
                raise AssertionError(f"bf16 encode: {out.dtype}")
        eager = states["bfloat16"]
        for mode, step in steps.items():
            for i in range(2 * SCAN_K):
                c0 = _counts()
                metrics = step(eager, {k: v[i] for k, v in stacked.items()})
                c1 = _counts()
                got = {k: c1[k] - c0[k] for k in c1}
                if got != EXPECTED_TRAIN[mode] or \
                        not math.isfinite(float(metrics["loss"])):
                    raise AssertionError(f"bf16 {mode}: launches {got}, loss "
                                         f"{float(metrics['loss'])}")
            for half in (slice(0, SCAN_K), slice(SCAN_K, 2 * SCAN_K)):
                multis[mode](graph, {k: v[half] for k, v in stacked.items()})
        c = _counts()
        launches = {k: c[k] for k in c}
        for mode, multi in multis.items():
            # the graph's launches: counted at capture, times its replays
            for k, n in multi.replayed_launches().items():
                launches[k] += n
        zoo_start = time.perf_counter()
        zoo, members = _bf16_zoo(launches)
        launches_read = dict(launches)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - start
        zoo["steps_s"] = time.perf_counter() - zoo_start
        log(f"launches on the bf16 path: {json.dumps(launches_read)}")
        a_, b_ = _scan_tensors(eager), _scan_tensors(graph)
        differ = sorted(n for n in a_ if not torch.equal(a_[n], b_[n]))
        kinds = {str(v.dtype) for v in a_.values()}
        log(f"bf16 scan: {len(a_)} parameters and Adam moments after "
            f"{2 * SCAN_K} steps a mode, eager vs graph: {len(differ)} "
            f"differ; dtypes {sorted(kinds)}; steps {eager.step} / "
            f"{graph.step}")
        if differ or eager.step != graph.step or not torch.equal(
                eager.generator.get_state(), graph.generator.get_state()):
            raise AssertionError(f"bf16 scan: graph and eager differ {differ}")
        rows = {}
        for mode, step in steps.items():
            rows[mode] = _bf16_kernels_on_step(
                f"{mode} step", lambda: step(eager, {
                    k: v[0] for k, v in stacked.items()}),
                timed=mode in ("action", "causal"))
        zoo["checks"] = _bf16_zoo_checks(members, smi)
        numbers = {"zoo": zoo, "vs_cpu": _bf16_vs_cpu(smi),
                   "in_turns": _bf16_in_turns(states, steps, {
                       k: v[0] for k, v in stacked.items()}, fns, args),
                   "path_s": path_s}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    numbers["wall_s"] = time.perf_counter() - start
    log(f"bf16: phase {numbers['wall_s']:.1f} s (path {path_s:.1f} s)")
    return launches_read, rows, numbers


def _bf16_summary(rows: dict, name: str) -> dict:
    """The kernels line's ``bf16`` entry of a kernel: its calls on the
    causal step (the row's numbers: ms, plain ms, bound on the largest
    call) and on the action step, and every mode's worst error."""
    calls = rows["causal"][name]
    if name == "vq_l2_argmin":
        return {"calls": {m: r[name] for m, r in rows.items()}}
    big = max(calls, key=lambda r: r["ms"])
    return {"ms": big["ms"], "f32_ms": big["f32_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None, "shape": big["shape"],
            "max_error": max(max(r["errors"]) for m in rows
                             for r in rows[m][name]),
            "on_causal_step": calls, "on_action_step": rows["action"][name]}


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


#: the CelebA stand-in sizes and the model seeds of factorvae_witness:
#: 4,800 images is the stand-in whose first batch once put FactorVAE's
#: first conv gradient 2.78 of its tolerance from the CPU
WITNESS_SIZES = (4_800, CELEBA_N)
WITNESS_SEEDS = (SEED, SEED + 1, SEED + 2)


def factorvae_witness(smi: str) -> dict:
    """A float64 witness of phase "gaussian"'s first FactorVAE call (the
    VAE's, optimizer 0, under deterministic cuDNN): on the first train
    batch of a CelebA stand-in of each of WITNESS_SIZES images, from the
    weights of each of WITNESS_SEEDS, the call's gradients on the card,
    on the CPU at float32 and on the CPU at float64 (the model, batch and
    draws in float64), both CPU sides on the card's draws. Each gradient's
    distance over the check's tolerance (1e-3 of max(1, its block's
    largest float32 CPU gradient)): card against the float32 CPU (what
    ``_step_vs_cpu`` holds), and each float32 side against float64. Per
    case, the gradient the check finds farthest, its three distances, and
    which float32 side lies farther from float64."""
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.data.prefetch import to_device
    from ctvae_torch.models import build_model
    from ctvae_torch.ops.layers import set_compute_dtype
    from ctvae_torch.training import (build_optimizers, create_train_state,
                                      make_train_step)
    from ctvae_torch.training import state as tstate
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for n_images in WITNESS_SIZES:
            with tempfile.TemporaryDirectory(prefix="ctvae_witness_") as tmp:
                _celeba_standin(tmp, smi, n_images)
                cfg = _gaussian_config("factorvae", tmp,
                                       os.path.join(tmp, "logs"))
                data = VAEDataset(**_gaussian_config(
                    "vae", tmp, os.path.join(tmp, "logs"))["data_params"])
                data.setup()
                first = next(iter(data.train_dataloader(0)))
                batch = to_device({"image": first["image"]}, "cuda")
            exp = _exp_params(cfg)
            M_N = float(exp.get("kld_weight", 1.0))
            for seed in WITNESS_SEEDS:
                model = build_model(cfg["model_params"], device="cuda",
                                    generator=torch.Generator(
                                        "cuda").manual_seed(seed))
                sides = {"card": model,
                         "cpu32": copy.deepcopy(model).to("cpu"),
                         "cpu64": copy.deepcopy(model).to("cpu").double()}
                set_compute_dtype(sides["cpu64"], torch.float64)
                grads, taken = {}, None
                for side, m in sides.items():
                    state = create_train_state(m, build_optimizers(
                        exp, m, steps_per_epoch=100), seed=SEED)
                    step = make_train_step("base", M_N=M_N, optimizer_idx=0)
                    b = {"image": batch["image"].to(
                        m.device, torch.float64 if side == "cpu64"
                        else torch.float32)}
                    if side == "card":
                        with _NonfiniteWatch(f"witness {n_images} {seed}"
                                             ) as watch:
                            step(state, b)
                        taken = watch.taken
                    else:
                        draws = [(k, t.double() if side == "cpu64" and
                                  t.is_floating_point() else t)
                                 for k, t in taken]
                        kept = tstate.Draws
                        tstate.Draws = (lambda generator, device, d=draws:
                                        _replay_taken(d, "cpu"))
                        try:
                            step(state, b)
                        finally:
                            tstate.Draws = kept
                    grads[side] = {n: p.grad.detach().cpu().double()
                                   for n, p in m.named_parameters()
                                   if p.grad is not None}
                scale = {}
                for n, g in grads["cpu32"].items():
                    block = n.rsplit(".", 2)[0]
                    scale[block] = max(scale.get(block, 1.0),
                                       float(g.abs().max()))

                def dist(a, b):
                    return {n: float((grads[a][n] - grads[b][n]).abs().max()
                                     / (1e-3 * scale[n.rsplit(".", 2)[0]]))
                            for n in grads["cpu32"]}
                d = {"card_vs_cpu32": dist("card", "cpu32"),
                     "card_vs_f64": dist("card", "cpu64"),
                     "cpu32_vs_f64": dist("cpu32", "cpu64")}
                worst = max(d["card_vs_cpu32"], key=d["card_vs_cpu32"].get)
                case = {"gradient": worst,
                        **{k: v[worst] for k, v in d.items()},
                        "farther_from_f64": (
                            "card" if d["card_vs_f64"][worst]
                            > d["cpu32_vs_f64"][worst] else "cpu32"),
                        "max": {k: max(v.values()) for k, v in d.items()}}
                out[f"{n_images}_seed{seed}"] = case
                log(f"factorvae witness, {n_images}-image stand-in, seed "
                    f"{seed}: {json.dumps(case)} ({smi})")
                del model, sides
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


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
        "--search-only", action="store_true",
        help="only build the kernels and run the phase \"search\" "
             "(phase_search)")
    parser.add_argument(
        "--gaussian-only", action="store_true",
        help="only build the kernels and run the phase \"gaussian\" "
             "(phase_gaussian)")
    parser.add_argument(
        "--celeba-only", action="store_true",
        help="only build the kernels, write the CelebA stand-in and run "
             "the phase \"celeba\" (phase_celeba)")
    parser.add_argument(
        "--export-only", action="store_true",
        help="only build the kernels and run the phase \"export\" "
             "(phase_export)")
    parser.add_argument(
        "--ddp-only", action="store_true",
        help="only build the kernels and run the phase \"ddp\" "
             "(phase_ddp)")
    parser.add_argument(
        "--sp-only", action="store_true",
        help="only build the kernels and run the phase \"sp\" "
             "(phase_sp)")
    parser.add_argument(
        "--fsdp-tp-only", action="store_true",
        help="only build the kernels and run the path \"fsdp_tp\" of "
             "phase \"sp\" (_fsdp_tp_path)")
    parser.add_argument(
        "--bf16-only", action="store_true",
        help="only build the kernels and run the phase \"bf16\" "
             "(phase_bf16)")
    parser.add_argument(
        "--metrics-only", action="store_true",
        help="only build the kernels and run the phase \"metrics\" "
             "(phase_metrics)")
    parser.add_argument(
        "--factorvae-witness", action="store_true",
        help="only build the kernels and take FactorVAE's first call on "
             "the card, the CPU and the CPU at float64 (factorvae_witness)")
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
    smi = walled("card", phase_card)
    walled("build", phase_build)
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
    if opts.search_only:
        launches, rows, numbers = walled("search", phase_search, smi)
        log(json.dumps({"search_launches": launches, "search": numbers,
                        "kernels": {k: _search_summary(r)
                                    for k, r in rows.items()}}))
        log_walls(start)
        return 0
    if opts.gaussian_only:
        with tempfile.TemporaryDirectory(prefix="ctvae_celeba_data_") as tmp:
            standin = walled("celeba_standin", _celeba_standin, tmp, smi)
            launches, vq_launches, vq_rows, numbers = walled(
                "gaussian", phase_gaussian, smi, tmp)
        log(json.dumps({"gaussian_launches": launches,
                        "gaussian_vq_launches": vq_launches,
                        "gaussian": numbers, "vq_at_k512": vq_rows,
                        "celeba_standin": standin}))
        log_walls(start)
        return 0
    if opts.celeba_only:
        with tempfile.TemporaryDirectory(prefix="ctvae_celeba_data_") as tmp:
            standin = walled("celeba_standin", _celeba_standin, tmp, smi)
            launches, vq_launches, tc_launches, vq_rows, tc_rows, numbers = \
                walled("celeba", phase_celeba, smi, tmp)
        log(json.dumps({"celeba_launches": launches,
                        "celeba_vq_launches": vq_launches,
                        "tceleba_launches": tc_launches,
                        "celeba": numbers, "celeba_standin": standin,
                        "vq_at_k512": vq_rows,
                        "kernels": {k: _search_summary(r)
                                    for k, r in tc_rows.items()}}))
        log_walls(start)
        return 0
    if opts.export_only:
        launches, bf16_launches, numbers = walled("export", phase_export,
                                                        smi)
        log(json.dumps({"export_launches": launches,
                        "export_bf16_launches": bf16_launches,
                        "export": numbers}))
        log_walls(start)
        return 0
    if opts.ddp_only:
        launches, fsdp_launches, bf16_launches, numbers = walled(
            "ddp", phase_ddp, smi)
        log(json.dumps({"ddp_launches": launches,
                        "fsdp_launches": fsdp_launches,
                        "ddp_bf16_launches": bf16_launches, "ddp": numbers}))
        log_walls(start)
        return 0
    if opts.sp_only:
        launches, tp_launches, numbers = walled("sp", phase_sp, smi)
        log(json.dumps({"sp_launches": launches,
                        "fsdp_tp_launches": tp_launches, "sp": numbers}))
        log_walls(start)
        return 0
    if opts.fsdp_tp_only:
        launches, numbers = walled("fsdp_tp", _fsdp_tp_path, smi)
        log(json.dumps({"fsdp_tp_launches": launches, "fsdp_tp": numbers}))
        log_walls(start)
        return 0
    if opts.bf16_only:
        launches, bf16_rows, numbers = walled("bf16", phase_bf16, smi)
        log(json.dumps({"bf16_launches": launches, "bf16": numbers,
                        "kernels": {k: _bf16_summary(bf16_rows, k)
                                    for k in KERNEL_META}}))
        log_walls(start)
        return 0
    if opts.metrics_only:
        launches, seconds = walled("metrics", phase_metrics, smi)
        log(json.dumps({"metrics_launches": launches,
                        "metric_seconds": seconds}))
        log_walls(start)
        return 0
    if opts.factorvae_witness:
        log(json.dumps({"factorvae_witness": factorvae_witness(smi)}))
        log_walls(start)
        return 0
    if opts.train_step_against:
        log(json.dumps({"train_step_against": compare_train_step(
            opts.train_step_against)}))
        return 0
    if opts.pairwise_bwd_against:
        log(json.dumps({"pairwise_bwd_against": compare_pairwise_bwd(
            opts.pairwise_bwd_against)}))
        return 0
    rows = walled("kernels", phase_kernels)
    model, timings, serve_launches = walled("serve", phase_serve)
    walled("reference", phase_reference, model)
    walled("profile", phase_profile, model)
    del model
    train_ms, train_launches, peak, on_step = walled("train", phase_train)
    c2_ms, c2_launches, c2_on_step = walled("codebooks_2", phase_codebooks_2)
    walled("loop", phase_loop)
    two_stage_launches = walled("two_stage", phase_two_stage)
    scan_launches, accum_launches, scan_ms = walled("scan", phase_scan)
    walled("bench", phase_bench)
    mcq_launches, ct_launches, s3d_on_step = walled("shapes3d",
                                                    phase_shapes3d)
    metric_launches, metric_seconds = walled("metrics", phase_metrics, smi)
    search_launches, search_rows, search_numbers = walled(
        "search", phase_search, smi)
    with tempfile.TemporaryDirectory(prefix="ctvae_celeba_data_") as tmp:
        standin = walled("celeba_standin", _celeba_standin, tmp, smi)
        (celeba_launches, celeba_vq_launches, tceleba_launches,
         celeba_vq_rows, tceleba_rows, celeba_numbers) = walled(
            "celeba", phase_celeba, smi, tmp)
        celeba_numbers["standin"] = standin
        gauss_launches, gauss_vq_launches, gauss_vq_rows, gauss_numbers = \
            walled("gaussian", phase_gaussian, smi, tmp)
    export_launches, export_bf16_launches, export_numbers = walled(
        "export", phase_export, smi)
    ddp_launches, fsdp_launches, ddp_bf16_launches, ddp_numbers = \
        walled("ddp", phase_ddp, smi)
    sp_launches, tp_launches, sp_numbers = walled("sp", phase_sp, smi)
    bf16_launches, bf16_rows, bf16_numbers = walled("bf16", phase_bf16,
                                                    smi)
    kernels = []
    for r in rows:
        source, replaces = KERNEL_META[r["name"]]
        by_path = {"serve": serve_launches[r["name"]],
                   "train": train_launches[r["name"]],
                   "codebooks_2": c2_launches[r["name"]],
                   "two_stage": two_stage_launches[r["name"]],
                   "scan": scan_launches[r["name"]],
                   "scan_accum": accum_launches[r["name"]],
                   "shapes3d_mcq": mcq_launches[r["name"]],
                   "shapes3d_ct": ct_launches[r["name"]],
                   "metrics": metric_launches[r["name"]],
                   "search": search_launches[r["name"]],
                   "gaussian_vq": gauss_vq_launches[r["name"]],
                   "gaussian": gauss_launches[r["name"]],
                   "celeba_vq": celeba_vq_launches[r["name"]],
                   "celeba": celeba_launches[r["name"]],
                   "tceleba": tceleba_launches[r["name"]],
                   "export": export_launches[r["name"]],
                   "export_bf16": export_bf16_launches[r["name"]],
                   "ddp": ddp_launches[r["name"]],
                   "fsdp": fsdp_launches[r["name"]],
                   "ddp_bf16": ddp_bf16_launches[r["name"]],
                   "sp": sp_launches[r["name"]],
                   "fsdp_tp": tp_launches[r["name"]],
                   "bf16": bf16_launches[r["name"]]}
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
        kernels[-1]["search"] = _search_summary(search_rows[r["name"]])
        kernels[-1]["tceleba"] = _search_summary(tceleba_rows[r["name"]])
        if r["name"] == "vq_l2_argmin":     # VQVAE's K = 512 calls
            kernels[-1]["gaussian_vq"] = gauss_vq_rows
            kernels[-1]["celeba_vq"] = celeba_vq_rows
        # the bfloat16 instantiation's numbers (the VQ search runs in
        # float32 on the upcast latents there)
        kernels[-1]["bf16"] = _bf16_summary(bf16_rows, r["name"])
    # every kernel runs on the training, codebooks: 2, two-stage, scan,
    # shapes3d CT, metrics, search and TCeleba CT paths, the forward ones
    # on the serving and export paths too, the VQ search alone on the
    # MCQVAE's and VQVAE's (which have no CT layer), none on the Gaussian
    # zoo's
    if any((k["launches_by_path"][p] == 0) != (k["name"] != "vq_l2_argmin")
           or k["launches_by_path"][g] for k in kernels
           for p, g in (("gaussian_vq", "gaussian"),
                        ("celeba_vq", "celeba"))) or any(
            k["launches_by_path"][p] == 0 for k in kernels
           for p in ("train", "codebooks_2", "two_stage", "scan",
                     "scan_accum", "shapes3d_ct", "metrics", "search",
                     "tceleba", "ddp", "fsdp", "bf16", "ddp_bf16", "sp",
                     "fsdp_tp")) or any(
            k["launches_by_path"]["serve"] == 0 for k in kernels
            if EXPECTED["reconstruct"][k["name"]]) or any(
            (k["launches_by_path"]["shapes3d_mcq"] == 0)
            != (k["name"] != "vq_l2_argmin") for k in kernels) or any(
            (k["launches_by_path"][p] == 0) != k["name"].endswith("_bwd")
            for k in kernels for p in ("export", "export_bf16")):
        raise AssertionError("a kernel of a path was never launched")
    log(json.dumps({"serve_ms": timings, "train_ms": train_ms,
                    "train_peak_gib": peak, "codebooks_2_train_ms": c2_ms,
                    "scan_ms": scan_ms, "metric_seconds": metric_seconds,
                    "search": search_numbers, "gaussian": gauss_numbers,
                    "celeba": celeba_numbers, "export": export_numbers,
                    "ddp": ddp_numbers, "sp": sp_numbers,
                    "bf16": bf16_numbers}))
    log_walls(start)
    log(f"chip_smoke wall time {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:
        # the phases' wall seconds up to the failure, beside the traceback
        print(json.dumps({"wall_s": WALL}), file=sys.stderr, flush=True)
        raise
