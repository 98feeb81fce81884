"""The port's two-stage CT recipe against the JAX package at small widths:
the MCQVAE (forward, loss, one train step), ``sample`` / ``walk`` /
``navigate``, the checkpoint manager's top-k bookkeeping, the
weights-only restore, a bit-identical full-state resume, the PNG writer,
and the entry points ``ctvae_torch.causal_train``, ``ctvae_torch.run``
(weights-only resume) and ``ctvae_torch.apply_action`` on the CPU.

Tolerances: values atol 1e-5 / rtol 1e-4 (f32 on both sides); the train
step as in tests/test_torch_training.py; PNG pixels, checkpoint indices
and resumed states exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ctvae_torch.convert import from_jax_params
from ctvae_torch.training import optimizers as topt
from ctvae_torch.training import state as tstate
from torch_port_common import (MCQ, SMALL, ReplayDraws, assert_step_matches,
                               batch, build_pair, close, jax_rngs,
                               jax_train_step, one_torch_thread,
                               recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0)


@pytest.fixture(scope="module")
def mcq_pair():
    """(JAX MCQVAE, its variables, the port's MCQVAE with those weights)."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.models import build_model
    jm = jax_build(dict(MCQ))
    x, _, _ = batch(0, B=2)
    variables = jax.jit(jm.init)(jax_rngs(0), jnp.asarray(x))
    tm = build_model(dict(MCQ), device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(variables), tm))
    return jm, variables, tm


@pytest.fixture(scope="module")
def ct_pair():
    return build_pair(seed=0)


# --- MCQVAE -----------------------------------------------------------------

def test_mcq_vae_forward_and_loss_match_jax(mcq_pair):
    jm, variables, tm = mcq_pair
    x, _, _ = batch(21)

    @jax.jit
    def jfwd(x):
        out = jm.apply(variables, x)
        return out, jm.loss_function(out)

    want, want_loss = jfwd(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got_loss = tm.loss_function(got)
    close(t2n(got["recons"]), want["recons"])
    assert set(got_loss) == set(want_loss) == {
        "loss", "Reconstruction_Loss", "VQ_Loss", "Codebook_Perplexity"}
    for k, v in want_loss.items():
        close(t2n(got_loss[k]), v)


def test_mcq_vae_train_step_matches_jax(monkeypatch, mcq_pair):
    """One train step on a transition batch (the MCQVAE takes and ignores
    ``input_y`` / ``action`` / ``mode``): loss terms, ``grad_norm``, every
    gradient and every parameter after Adam."""
    import copy
    jm, variables, tm0 = mcq_pair
    tm = copy.deepcopy(tm0)
    x, y, a = batch(22)
    b = {"image": x, "input_y": y, "action": a}
    j_params, j_grads, j_metrics, draws = jax_train_step(
        jm, variables, "action", {k: jnp.asarray(v) for k, v in b.items()},
        monkeypatch, seed=23, exp=EXP)
    assert not draws
    state = tstate.create_train_state(tm, topt.build_optimizers(EXP, tm, 4))
    metrics = tstate.make_train_step("action")(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        close(t2n(metrics[k]), v)
    assert_step_matches(tm, j_params, j_grads, EXP["LR"])


# --- generation ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["sample", "walk", "navigate"])
def test_generation_matches_jax(monkeypatch, ct_pair, mcq_pair, fn):
    """CTMCQVAE.sample / walk / navigate (and MCQVAE.sample) against the
    JAX methods with the same normal / randint draws; navigate draws
    nothing."""
    jm, variables, tm = ct_pair
    x, y, _ = batch(24)
    calls = {"sample": ((5,), {}), "walk": ((3, 2, 2), {}),
             "navigate": ((x[0], y[0], 3), {"save_inds": True})}
    args, kw = calls[fn]
    static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
    runs = [(jm, variables, tm)] + ([mcq_pair] if fn == "sample" else [])
    for jmod, jvars, tmod in runs:
        jfn = jax.jit(functools.partial(
            jmod.apply, jvars, method=getattr(jmod, fn), **kw),
            static_argnums=static)
        with recorded_draws(monkeypatch, seed=25) as rec:
            want = jfn(*args, rngs={"reparam": jax.random.PRNGKey(0)})
        assert (not rec.draws) == (fn == "navigate")
        replay = ReplayDraws(rec.draws)
        with torch.no_grad():
            if fn == "navigate":
                got = tmod.navigate(*[torch.from_numpy(a) for a in args[:2]],
                                    args[2], **kw)
            else:
                got = getattr(tmod, fn)(*args, draws=replay)
        assert replay.done()
        if fn == "navigate":
            close(t2n(got[0]), want[0])
            np.testing.assert_array_equal(t2n(got[1]), np.asarray(want[1]))
        else:
            close(t2n(got), want)


# --- checkpoints --------------------------------------------------------------

class _Blob:
    """A train state stand-in: what ``CheckpointManager.save`` takes."""

    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"model": {"w": torch.full((2,), float(self.step))},
                "step": self.step}


def test_checkpoint_manager_topk_matches_jax(tmp_path):
    """The same score sequence through the JAX manager (orbax) and the
    port's: the same top-2 index, the same files kept, ``last`` holding
    the newest state; ``best`` and the ``.old`` fallback restore."""
    from ctvae_tpu.utils.checkpoint import CheckpointManager as JManager
    from ctvae_torch.utils.checkpoint import CheckpointManager
    jcm = JManager(str(tmp_path / "jax"), top_k=2)
    cm = CheckpointManager(str(tmp_path / "torch"), top_k=2)
    scores = [3.0, 1.0, 2.0, 0.5, None, 4.0, 1.5]
    for step, score in enumerate(scores, start=1):
        metrics = None if score is None else {"val_Reconstruction_Loss":
                                              score, "val_loss": 9.0}
        jcm.save({"w": np.full((2,), float(step), np.float32)}, step,
                 metrics=metrics)
        cm.save(_Blob(step), step, metrics=metrics)

    def index(manager):
        return [(e["step"], e["score"], os.path.basename(e["path"]))
                for e in manager._index["best"]]

    assert index(cm) == index(jcm) == [(4, 0.5, "step_4"),
                                       (2, 1.0, "step_2")]
    assert sorted(os.listdir(cm.dir)) == sorted(os.listdir(jcm.dir)) == [
        "index.json", "last", "step_2", "step_4"]
    assert cm.restore("last")["step"] == 7
    assert cm.restore("best")["step"] == 4
    assert CheckpointManager(cm.dir).restore("best")["step"] == 4  # reread
    os.rename(cm.path("last"), cm.path("last") + ".old")
    assert cm.restore("last")["step"] == 7
    with pytest.raises(FileNotFoundError):
        cm.restore(str(tmp_path / "missing"))


def test_checkpoint_serialises_each_state_once(tmp_path, monkeypatch):
    """A validated save writes the state once, as ``step_<n>``; ``last``
    names that same file, and outlives its eviction from the top-k."""
    from ctvae_torch.utils import checkpoint
    saves = []
    real = checkpoint.torch.save
    monkeypatch.setattr(checkpoint.torch, "save",
                        lambda blob, path: saves.append(path) or
                        real(blob, path))
    cm = checkpoint.CheckpointManager(str(tmp_path), top_k=1)
    cm.save(_Blob(1), 1, metrics={"val_Reconstruction_Loss": 1.0})
    assert len(saves) == 1
    assert os.path.samefile(cm.path("last"), os.path.join(cm.dir, "step_1"))
    cm.save(_Blob(2), 2, metrics={"val_Reconstruction_Loss": 2.0})  # evicted
    assert len(saves) == 2
    assert sorted(os.listdir(cm.dir)) == ["index.json", "last", "step_1"]
    assert cm.restore("last")["step"] == 2
    assert cm.restore("best")["step"] == 1


def _fresh_state(model, seed):
    from ctvae_torch.training import build_optimizers, create_train_state
    return create_train_state(model, build_optimizers({}, model), seed)


def test_load_weights_only_mcq_into_ct(tmp_path):
    """An MCQVAE checkpoint restored weights-only into a CTMCQVAE: every
    backbone tensor lands, ``ct_layer`` keeps its init; into a CTMCQVAE of
    one codebook, the shape-mismatched codebook keeps its init too."""
    from ctvae_torch.models import build_model
    from ctvae_torch.utils.checkpoint import (CheckpointManager,
                                              load_weights_only)
    mcq = build_model(dict(MCQ), device="cpu",
                      generator=torch.Generator().manual_seed(1))
    cm = CheckpointManager(str(tmp_path))
    cm.save(_fresh_state(mcq, 0), 0)
    src = mcq.state_dict()
    for cfg in (SMALL, dict(SMALL, codebooks=1)):
        ct = build_model(dict(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(2))
        fresh = {n: t.clone() for n, t in ct.state_dict().items()}
        loaded = load_weights_only(cm.path("last"), ct)
        now = ct.state_dict()
        want = [n for n in now if n in src and src[n].shape == now[n].shape]
        assert sorted(loaded) == sorted(want)
        assert all(not n.startswith("ct_layer.") for n in loaded)
        for n, t in now.items():
            assert torch.equal(t, src[n] if n in loaded else fresh[n]), n
    assert "vq_layer.quantizers_0.embedding" not in loaded   # [8, 8] vs [8, 4]


def _experiment(tmp, seed=3, ckpt=True):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    data = VAEDataset("", dataset_name="TSynthetic", train_batch_size=8,
                      val_batch_size=8, patch_size=16, limit=24,
                      val_limit=8, seed=5)
    data.setup()
    model = build_model(dict(SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    manager = CheckpointManager(str(tmp)) if ckpt else None
    return VAEXperiment(model, dict(EXP), data, ckpt_manager=manager)


def test_full_state_resume_is_bit_identical(tmp_path):
    """1 epoch + checkpoint + full-state restore into a fresh experiment
    (other init, other seed) + 1 epoch equals 2 straight epochs bit for
    bit: parameters, Adam moments and steps, LR-schedule position, step,
    generator and the last epoch's train metrics."""
    straight = _experiment(tmp_path / "a", ckpt=False)
    want = straight.fit(2, seed=11)
    first = _experiment(tmp_path / "b")
    first.fit(1, seed=11)
    resumed = _experiment(tmp_path / "b", seed=4)
    resumed.setup(seed=12)
    resumed.restore_full_state("last")
    assert resumed.start_epoch == 1 and resumed.global_step == 9
    got = resumed.fit(2, seed=11)
    for k, v in want.items():
        if k.startswith("train_") and k != "train_images_per_sec":
            assert got[k] == v, k
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    assert a["step"] == b["step"] == 18
    assert torch.equal(a["generator"], b["generator"])
    for n, t in a["model"].items():
        assert torch.equal(t, b["model"][n]), n
    (oa,), (ob,) = a["optimizers"], b["optimizers"]
    assert oa["count"] == ob["count"] == 18
    for i, st in oa["adam"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, ob["adam"]["state"][i][k]), (i, k)


# --- images -------------------------------------------------------------------

@pytest.mark.parametrize("channels,normalize", [(3, True), (1, False)])
def test_save_image_matches_jax_png(tmp_path, channels, normalize):
    """The port's standard-library PNG writer against the JAX package's
    PIL one, decoded with PIL, pixel for pixel."""
    from PIL import Image

    from ctvae_tpu.utils import images as jimages
    from ctvae_torch.utils import images as timages
    rng = np.random.default_rng(channels)
    imgs = rng.uniform(-0.2, 1.2, size=(5, 7, 9, channels)).astype(
        np.float32)
    jimages.save_image(imgs, str(tmp_path / "jax.png"), nrow=3,
                       normalize=normalize)
    timages.save_image(imgs, str(tmp_path / "sub" / "torch.png"), nrow=3,
                       normalize=normalize)
    with Image.open(tmp_path / "jax.png") as j, \
            Image.open(tmp_path / "sub" / "torch.png") as t:
        assert t.mode == j.mode and t.size == j.size
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_array_equal(timages.to_uint8(imgs),
                                  jimages.to_uint8(imgs))


# --- entry points -------------------------------------------------------------

def test_causal_train_two_stage_cli(monkeypatch, capsys):
    """``python -m ctvae_torch.causal_train --epochs 1 --pretrain-epochs 1
    --device cpu`` (a smaller factor grid than the default): the JAX
    script's JSON keys, the two-stage recipe, and a backbone bit-unchanged
    from the weights-only restore to the end of training."""
    from ctvae_torch import causal_train
    from ctvae_torch.training import VAEXperiment
    seen = {}
    load = VAEXperiment.load_weights

    def spy(self, path):
        load(self, path)
        seen["exp"] = self
        seen["backbone"] = {n: t.clone() for n, t in
                            self.model.state_dict().items()
                            if not n.startswith("ct_layer.")}

    monkeypatch.setattr(VAEXperiment, "load_weights", spy)
    result = causal_train.main(["--epochs", "1", "--pretrain-epochs", "1",
                                "--device", "cpu", "--factor-sizes",
                                "3,3,2,2", "--batch", "8"])
    with open(os.path.join(REPO, "assets", "causal_r5",
                           "jax_2stage_s0.json")) as f:
        jax_keys = set(json.load(f))
    assert set(result) == jax_keys
    assert result["framework"] == "ctvae_torch"
    assert result["recipe"] == "two_stage" and result["pretrain_epochs"] == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    now = seen["exp"].model.state_dict()
    assert seen["exp"].global_step > 0
    for n, t in seen["backbone"].items():
        assert torch.equal(now[n], t), n


def test_run_weights_only_resume_and_apply_action(tmp_path):
    """``ctvae_torch.run``: an MCQVAE run, then a CTMCQVAE run restoring
    its ``last`` checkpoint weights-only and training ``ct_layer`` alone,
    then ``ctvae_torch.apply_action`` on that run's checkpoint with a walk
    and a navigation (the JAX package's file names and counts)."""
    from ctvae_torch import apply_action, run
    logdir = str(tmp_path / "logs")

    def config(model, **trainer):
        cfg = {"model_params": model,
               "data_params": {"data_path": "", "dataset_name": "TSynthetic",
                               "train_batch_size": 8, "val_batch_size": 8,
                               "patch_size": 16, "limit": 24,
                               "val_limit": 16},
               "exp_params": {"LR": 0.001, "manual_seed": 7,
                              **({"update_parameters": "ct_layer"}
                                 if model["name"] == "CTMCQVAE" else {})},
               "trainer_params": {"max_epochs": 1, **trainer},
               "logging_params": {"save_dir": logdir, "name": "ct"}}
        path = str(tmp_path / f"cfg_{len(os.listdir(tmp_path))}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    run.main(["-c", config(dict(MCQ)), "--device", "cpu"])
    ckpt = os.path.join(logdir, "ct", "version_0", "checkpoints", "last")
    cfg2 = config(dict(SMALL), resume_from_checkpoint=ckpt,
                  load_weights_only=True)
    run.main(["-c", cfg2, "--device", "cpu"])
    ckpt2 = os.path.join(logdir, "ct", "version_1", "checkpoints", "last")
    stage1 = torch.load(ckpt, weights_only=True)["model"]
    stage2 = torch.load(ckpt2, weights_only=True)["model"]
    assert stage2["ct_layer.disc_b1"].any()     # ct_layer trained
    for n, t in stage1.items():
        assert torch.equal(stage2[n], t), n     # backbone restored, frozen

    out = apply_action.main(["-c", cfg2, "--ckpt", ckpt2, "--out",
                             str(tmp_path / "images"), "--steps", "1",
                             "--walk", "2,2,1", "--navigate", "1",
                             "--device", "cpu"])
    names = [os.path.basename(p) for p in out["images"]]
    assert names[0] == "CT-VAE_input_TSynthetic.png"
    assert len([n for n in names if n.startswith("CT-VAE_output")]) == 8
    assert len([n for n in names if n.startswith("CT-VAE_walk")]) == 4
    assert len([n for n in names if n.startswith("CT-VAE_navigate")]) == 3
    assert sorted(os.listdir(out["out_dir"])) == sorted(names)
    assert out["causal_batches"] > 0 and np.isfinite(out["causal_acc"])
