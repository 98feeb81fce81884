"""The port's bench (``ctvae_torch/bench.py``) on the CPU, at a tiny
config: its result line, that it writes no file, its analytic operation
count against a hand count, the config reader it uses against PyYAML,
and that an explicit CUDA device without a card raises."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from ctvae_torch import bench
from ctvae_torch.config import read_section

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = """\
# a CT-MCQ-VAE of a few channels: S = 16 sites, 17 GAT nodes, 5 heads
model_params:
  name: CTMCQVAE
  in_channels: 3
  embedding_dim: 8
  action_dim: 4
  hidden_dims: [8, 16]
  num_embeddings: 8
  img_size: 16
  codebooks: 1
  causal_hidden_dims: [16, 8]
  noise: 'off'
"""

KEYS = ["device", "config", "dtype", "ct_action_img_per_sec"] + [
    f"ct_{m}_{k}" for m in ("base", "action", "causal")
    for k in ("ms_per_step", "ms_per_step_scan8", "device_ms_per_step",
              "launches_per_step", "step_mfu")] + [
    f"serve_{e}_ms" for e in ("reconstruct", "encode", "apply_action",
                              "classify_action")]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """``python -m ctvae_torch.bench --device cpu`` on the tiny config at
    the bench's batches, one block of two steps (requests) per tier, from
    an empty working directory; torch on one thread (the tests run beside
    each other)."""
    root = tmp_path_factory.mktemp("bench")
    config = root / "tiny.yaml"
    config.write_text(TINY)
    work = root / "work"
    work.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ctvae_torch.bench", "--config", str(config),
         "--device", "cpu", "--blocks", "1", "--block-steps", "2"],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, work, str(config)


def test_bench_ends_with_one_short_json_line(cpu_run):
    out, _, config = cpu_run
    last = out.splitlines()[-1]
    assert len(last) <= 1500
    result = json.loads(last)
    assert set(KEYS) <= set(result), set(KEYS) - set(result)
    assert result["device"] == "cpu" and result["dtype"] == "float32"
    assert result["config"] == config
    for m in ("base", "action", "causal"):
        assert result[f"ct_{m}_ms_per_step"] > 0
        assert result[f"ct_{m}_ms_per_step_scan8"] > 0
        # the card's numbers are not measured on the CPU
        for k in ("device_ms_per_step", "launches_per_step", "step_mfu"):
            assert result[f"ct_{m}_{k}"] is None
    assert result["ct_action_img_per_sec"] == pytest.approx(
        bench.BATCH * 1e3 / result["ct_action_ms_per_step"], rel=1e-3)
    assert all(result[f"serve_{e}_ms"] > 0 for e in bench.SERVE_FNS)


def test_bench_writes_no_file(cpu_run):
    assert os.listdir(cpu_run[1]) == []


def test_step_flops_equal_a_hand_count():
    """``step_flops`` of the tiny config at B = 2, counted here layer by
    layer (fma = 2). Per image: the encoder's convolutions 3 -> 8 (k4, 8 x
    8 out), 8 -> 16 (k4, 4 x 4), 16 -> 16 (k3), six residual layers (k3
    and k1, 16 -> 16) and 16 -> 8 (k1); the decoder's 8 -> 16 (k3), six
    residual layers and the transposed 16 -> 8 (k4 over 4 x 4) and 8 -> 3
    (k4 over 8 x 8). The causal transition: S = 16 sites, T = 17 nodes, N
    = 8 codes, A = 4 actions, 5 heads, discoverer hidden 16, one hidden
    GAT layer of 8 per head."""
    enc = (2 * 64 * 3 * 8 * 16 + 2 * 16 * 8 * 16 * 16 + 2 * 16 * 16 * 16 * 9
           + 6 * (2 * 16 * 16 * 16 * 9 + 2 * 16 * 16 * 16)
           + 2 * 16 * 16 * 8)
    dec = (2 * 16 * 8 * 16 * 9 + 6 * (2 * 16 * 16 * 16 * 9
                                      + 2 * 16 * 16 * 16)
           + 2 * 16 * 16 * 8 * 16 + 2 * 64 * 8 * 3 * 16)
    assert (enc, dec) == (684032, 643072)

    def ct(B, Bv, K, identity, mask):
        dense = (2 * (2 * B * 16 * 8 * 16)         # u0, v0 on B
                 + 2 * (2 * Bv * 16 * 8 * 16)      # ui, vi on Bv
                 + 2 * Bv * 4 * 8                  # a_dense
                 + 2 * (2 * Bv * 17 * 8 * 40)      # hidden lin_l, lin_r
                 + 2 * (2 * Bv * 17 * 40 * K * 8)  # kept heads' lin_l, r
                 + 2 * Bv * 17 * 17 * K * 8)       # alpha x xl
        if mask:
            dense += 2 * Bv * 16 * (4 + 8) * 8     # intervention mask
        if identity:
            dense += 2 * B * 16 * 8 * 40 + 2 * B * 16 * 40 * 8
        elem = ((4 + 5) * (B + Bv) * 16 * 16 * 16  # pairwise scores
                + (9 + 17) * Bv * 17 * 17 * 5 * 8  # hidden GAT layer
                + (5 + 10) * Bv * 17 * 17 * K * 8)  # kept heads' logits
        return 3 * dense + elem

    p = yaml.safe_load(TINY)["model_params"]
    want = {"base": 3 * (2 * enc + 2 * dec) + ct(2, 2, 1, True, False),
            "action": 3 * (4 * enc + 2 * dec) + ct(2, 2, 2, False, True),
            "causal": 4 * enc + ct(2, 8, 2, False, True)}
    assert want == {"base": 9290992, "action": 13518400, "causal": 8173824}
    assert {m: bench.step_flops(p, m, 2) for m in want} == want


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yaml"))), ids=os.path.basename)
def test_read_section_matches_yaml(path):
    """The reader of the bench and the smoke run against PyYAML on every
    section of every config (block and flow mappings)."""
    with open(path) as f:
        want = yaml.safe_load(f)
    assert {k: read_section(path, k) for k in want} == want


def test_read_section_refuses_what_it_does_not_read(tmp_path):
    config = tmp_path / "odd.yaml"
    config.write_text("a: {name: CTMCQVAE, inner: {x: 1}}\nb: 3\n")
    with pytest.raises(ValueError, match="nested mapping"):
        read_section(str(config), "a")
    with pytest.raises(ValueError, match="not a mapping"):
        read_section(str(config), "b")
    with pytest.raises(ValueError, match="no c section"):
        read_section(str(config), "c")


def test_explicit_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """``--device cuda`` (and the default, cuda) on a machine without a
    card raises before any tier runs: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tmp_path / "tiny.yaml"
    config.write_text(TINY)
    for device in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.main(["--config", str(config), *device])
