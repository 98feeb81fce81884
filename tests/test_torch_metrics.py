"""The port's disentanglement metrics and the loop's services against the
JAX package and sklearn, on the CPU.

* ``metrics/info.py``: ``mutual_info`` against sklearn's
  ``mutual_info_score`` (1e-12), ``discretize`` against the JAX
  ``_discretize`` (exact, constant and tiny-range columns included).
* ``metrics/linear_svc.py`` against ``LinearSVC(C=0.01,
  class_weight="balanced", dual="auto", max_iter=2000)``: coef and
  intercept within 1e-4 (liblinear stops at a gradient tolerance of 1e-4;
  the port solves to convergence), predictions equal on points farther
  than 1e-3 from every class boundary.
* ``metrics/gbt.py`` against ``GradientBoostingClassifier(random_state=0)``
  on inputs without a tied split (asserted: ``fit.ties == 0``; where
  candidates tie, sklearn's choice follows its random feature order):
  raw predictions and ``feature_importances_`` within 1e-10, predictions
  equal, on the training points and on new ones.
* each metric against ``ctvae_tpu.metrics`` on the cross-validation
  problem of ``tests/test_metrics_crossval.py``: MIG, SAP and FactorVAE
  within 1e-12; DCI's four numbers within 0.005 (disentanglement,
  completeness) and 0.01 (informativeness) of JAX's at ``random_state=0``:
  its trees tie often, and sklearn's own fits over ``random_state`` 0-4
  span 0.0014 / 0.0020 of disentanglement / completeness there, the
  port's over its seeds 0-4 0.0040 / 0.0021
  (``tests/torch_metrics_sweep.py``);
* ``MetricSet``'s keys and argument fixups, the samplers' draws and
  images, ``repr_fn`` of a converted CTMCQVAE, ``run.train`` with
  ``exp_params.metrics``, the ``watch_gradients`` norms (the step tests'
  1e-5), asynchronous checkpoints and the ``profile`` trace.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (SMALL, ReplayDraws, _jax_native_lib, batch,
                               build_pair, close, jax_native,
                               one_torch_thread, recorded_draws, t2n)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["DCI", "MIG", "SAP", "FactorVaeScore"]


# --- info: discretisation and mutual information ---------------------------

def _columns(dtype):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(300, 7)).astype(dtype)
    z[:, 3] = 2.5                       # constant: bins around 2.5 +- 0.5
    z[:, 5] *= 1e-6                     # tiny range
    z[:, 6] = np.round(z[:, 6], 1)      # repeated values
    return z


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_discretize_matches_jax(dtype):
    from ctvae_tpu.metrics.disentanglement import _discretize
    from ctvae_torch.metrics.info import discretize, histogram_edges
    z = _columns(dtype)
    got = discretize(torch.from_numpy(z)).numpy()
    assert np.array_equal(got, _discretize(z))
    edges = histogram_edges(torch.from_numpy(z)).numpy()
    for i in range(z.shape[1]):
        want = np.histogram(z[:, i], 20)[1]
        assert edges.dtype == want.dtype and np.array_equal(edges[i], want)


def test_mutual_info_matches_sklearn():
    from sklearn.metrics import mutual_info_score
    from ctvae_torch.metrics.info import discretize, mutual_info
    rng = np.random.default_rng(1)
    d = discretize(torch.from_numpy(_columns(np.float32))).numpy()
    f = np.stack([rng.integers(0, s, 300) for s in (4, 5, 1, 6)], 1)
    f[:, 0] = d[:, 0] % 4                      # a factor the code reads
    mi = mutual_info(torch.from_numpy(d), torch.from_numpy(f)).numpy()
    want = np.array([[mutual_info_score(f[:, j], d[:, i]) for j in range(4)]
                     for i in range(d.shape[1])])
    assert np.abs(mi - want).max() <= 1e-12
    h = np.diagonal(mutual_info(torch.from_numpy(f),
                                torch.from_numpy(f)).numpy())
    want_h = [mutual_info_score(f[:, j], f[:, j]) for j in range(4)]
    assert np.abs(h - want_h).max() <= 1e-12 and h[2] == 0.0


# --- the one-feature linear SVMs -------------------------------------------

@pytest.mark.parametrize("K", [2, 3, 4])
def test_linear_svc_matches_sklearn(K):
    from sklearn.svm import LinearSVC
    from ctvae_torch.metrics.linear_svc import (fit_linear_svc,
                                                predict_linear_svc)
    rng = np.random.default_rng(K)
    n = 320
    p = np.arange(1, K + 1) / np.arange(1, K + 1).sum()   # unbalanced
    y = rng.choice(K, n, p=p) * 3 + 1                     # labels 1, 4, ..
    x = (y[:, None] * rng.normal(size=5) * 0.3
         + rng.normal(size=(n, 5))).astype(np.float32)
    x_te = (y[:, None] * rng.normal(size=5) * 0.3
            + rng.normal(size=(n, 5))).astype(np.float32)
    fit = fit_linear_svc(torch.from_numpy(x), torch.from_numpy(y))
    pred = predict_linear_svc(fit, torch.from_numpy(x_te)).numpy()
    for d in range(5):
        clf = LinearSVC(C=0.01, class_weight="balanced", dual="auto",
                        max_iter=2000).fit(x[:, [d]], y)
        assert np.array_equal(fit.classes.numpy(), clf.classes_)
        assert np.abs(fit.coef[d].numpy() - clf.coef_[:, 0]).max() <= 1e-4
        assert np.abs(fit.intercept[d].numpy()
                      - clf.intercept_).max() <= 1e-4
        scores = clf.decision_function(x_te[:, [d]]).reshape(n, -1)
        if scores.shape[1] == 1:
            margin = np.abs(scores[:, 0])
        else:
            top = np.sort(scores, 1)
            margin = top[:, -1] - top[:, -2]
        far = margin > 1e-3
        assert far.mean() > 0.95
        assert np.array_equal(pred[far, d], clf.predict(x_te[far][:, [d]]))


# --- the boosted trees -----------------------------------------------------

# (classes, features, rounds, seed): inputs whose fits have no tied split
GBT_CASES = [(2, 6, 10, 1), (4, 4, 10, 9)]


def _gbt_data(K, D, seed, n=300):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n)
    W = rng.normal(size=(K, D))
    x = (W[y] + rng.normal(size=(n, D))).astype(np.float32)
    x[:, 1] = 1.5                        # a constant feature
    x[:, 2] = np.round(x[:, 2], 1)       # repeated values
    return x, y


@pytest.mark.parametrize("K,D,rounds,seed", GBT_CASES)
def test_gbt_matches_sklearn(K, D, rounds, seed):
    from sklearn.ensemble import GradientBoostingClassifier
    from ctvae_torch.metrics.gbt import decision_function, fit_gbt, \
        predict_gbt
    x, y = _gbt_data(K, D, seed)
    x_new, _ = _gbt_data(K, D, seed + 100)
    fit = fit_gbt(torch.from_numpy(x), torch.from_numpy(y),
                  n_estimators=rounds)
    assert int(fit.ties) == 0
    clf = GradientBoostingClassifier(n_estimators=rounds,
                                     random_state=0).fit(x, y)
    for pts in (x, x_new):
        raw = decision_function(fit, torch.from_numpy(pts)).numpy()
        want = clf.decision_function(pts).reshape(len(pts), -1)
        assert np.abs(raw - want).max() <= 1e-10
        assert np.array_equal(predict_gbt(fit, torch.from_numpy(pts)).numpy(),
                              clf.predict(pts))
    assert np.abs(fit.importances.numpy()
                  - clf.feature_importances_).max() <= 1e-10
    assert fit.importances[1] == 0          # the constant feature


def test_solvers_in_feature_chunks_equal_one_block(monkeypatch):
    """The split search and the SVMs over code columns in several chunks
    (as at D = 8,192 on the card) give the one-block results: equal
    trees, importances and coefficients."""
    from ctvae_torch.metrics import gbt, linear_svc
    x, y = _gbt_data(5, 8, 3, n=200)
    one = gbt.fit_gbt(torch.from_numpy(x), torch.from_numpy(y),
                      n_estimators=5)
    svc_one = linear_svc.fit_linear_svc(torch.from_numpy(x),
                                        torch.from_numpy(y))
    monkeypatch.setattr(gbt, "CHUNK_ELEMENTS", 5 * 200 * 3)
    monkeypatch.setattr(linear_svc, "CHUNK_ELEMENTS", 5 * 200 * 3)
    many = gbt.fit_gbt(torch.from_numpy(x), torch.from_numpy(y),
                       n_estimators=5)
    svc_many = linear_svc.fit_linear_svc(torch.from_numpy(x),
                                         torch.from_numpy(y))
    for a, b in zip(one, many):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(svc_one.coef, svc_many.coef)
    assert torch.equal(svc_one.intercept, svc_many.intercept)


# --- the metrics against ctvae_tpu.metrics ---------------------------------

@pytest.fixture(scope="module")
def crossval():
    from test_metrics_crossval import TableSampler, _z_table, repr_fn
    return _z_table(), TableSampler, repr_fn


def test_mig_sap_factor_vae_match_jax(crossval):
    from ctvae_tpu.metrics import disentanglement as J
    from ctvae_torch.metrics import disentanglement as T
    z, S, repr_fn = crossval
    for name, seed, kw in (
            ("metric_mig", 3, dict(num_train=600)),
            ("metric_sap", 5, dict(num_train=600, num_test=300)),
            ("metric_factor_vae", 11, dict(num_train=300, num_eval=150,
                                           batch_size=32,
                                           num_variance_estimate=256))):
        want = getattr(J, name)(S(z, seed=seed), repr_fn, **kw)
        got = getattr(T, name)(S(z, seed=seed), repr_fn, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-12), (name, k)


def test_dci_matches_jax(crossval):
    from ctvae_tpu.metrics import disentanglement as J
    from ctvae_torch.metrics import disentanglement as T
    z, S, repr_fn = crossval
    kw = dict(num_train=400, num_test=200, batch_size=64, n_estimators=40)
    want = J.metric_dci(S(z, seed=7), repr_fn, random_state=0, **kw)
    got = T.metric_dci(S(z, seed=7), repr_fn, **kw)
    assert set(got) == set(want)
    for k in ("dci.disentanglement", "dci.completeness"):
        assert abs(got[k] - want[k]) <= 0.005, (k, got[k], want[k])
    for k in ("dci.informativeness_train", "dci.informativeness_test"):
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])
    assert 0.0 < got["dci.disentanglement"] < 1.0


def test_metric_set_keys_and_args_match_jax(crossval):
    from ctvae_tpu.metrics import Metric as JMetric
    from ctvae_tpu.metrics import MetricSet as JSet
    from ctvae_torch.metrics import Metric, MetricSet
    z, S, repr_fn = crossval
    for name in NAMES:
        kw = dict(batch_size=16, num_train=48, num_test=32)
        assert Metric(name, S(z), **kw).args == JMetric(name, S(z),
                                                        **kw).args, name
    kw = dict(batch_size=16, num_train=48, num_test=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JSet(NAMES, S(z), **kw).compute(repr_fn)
    got = MetricSet(NAMES, S(z), **kw).compute(repr_fn)
    assert list(got) == list(want)
    assert all(np.isfinite(v) for v in got.values())


def _grid_sampler_pair():
    """The grid path's datasets (a disent dataset through its transform)
    of both packages, on one seeded image grid."""
    from ctvae_tpu.data import disent_data as jdd
    from ctvae_tpu.data import transforms as jtr
    from ctvae_torch.data import disent_data as tdd
    from ctvae_torch.data import transforms as ttr
    sizes = (4, 3, 2)
    grid = np.indices(sizes).reshape(3, -1).T
    imgs = np.random.default_rng(0).integers(0, 256, (len(grid), 12, 12, 3),
                                             dtype=np.uint8)
    return (jdd.ArrayFactorDataset(imgs, grid, sizes, "/nonexistent", "x",
                                   split="all",
                                   transform=jtr.StandardTransform(8, 10)),
            tdd.ArrayFactorDataset(imgs, grid, sizes, "/nonexistent", "x",
                                   split="all",
                                   transform=ttr.StandardTransform(8, 10)))


def test_samplers_match_jax(jax_native):
    """Factors and observations of the grid path (a disent dataset through
    its transform), the procedural path (``SyntheticDataset``) and the
    row path (``SyntheticGridDataset``), from equal seeds; fixed-factor
    sampling refused on the row path by both. The JAX transform is pinned
    to its native float path (``jax_native``), which the port copies."""
    from ctvae_tpu.data import synthetic as jsyn
    from ctvae_tpu.metrics import GroundTruthSampler as JSampler
    from ctvae_torch.data import synthetic as tsyn
    from ctvae_torch.metrics import GroundTruthSampler as TSampler
    pairs = [
        _grid_sampler_pair(),
        (jsyn.SyntheticDataset(n=40, img_size=16),
         tsyn.SyntheticDataset(n=40, img_size=16)),
        (jsyn.SyntheticGridDataset(img_size=16),
         tsyn.SyntheticGridDataset(img_size=16))]
    for jds, tds in pairs:
        js = JSampler(jds, rng=np.random.default_rng(5))
        ts = TSampler(tds, rng=np.random.default_rng(5))
        for n in (7, 16):
            (jf, jx), (tf, tx) = js.sample(n), ts.sample(n)
            assert np.array_equal(jf, tf)
            assert np.abs(np.asarray(jx, np.float32)
                          - np.asarray(tx, np.float32)).max() <= 1e-6
        if js._grid or js._own:
            f = js.sample_factors(5)
            assert np.array_equal(f, ts.sample_factors(5))
        else:
            for s in (js, ts):
                with pytest.raises(NotImplementedError):
                    s.observations_from_factors(np.zeros((2, 4), np.int64))


def test_sampler_reference_is_not_the_pil_path(monkeypatch):
    """What the port deliberately does not copy: with the JAX native
    library off, JAX's transform takes its per-image PIL path, which
    rounds to uint8, and its observations leave the port's by more than
    1e-3."""
    from ctvae_tpu import native
    from ctvae_tpu.metrics import GroundTruthSampler as JSampler
    from ctvae_torch.metrics import GroundTruthSampler as TSampler
    monkeypatch.setenv("CTVAE_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    jds, tds = _grid_sampler_pair()
    (jf, jx), (tf, tx) = (JSampler(jds, rng=np.random.default_rng(5))
                          .sample(16),
                          TSampler(tds, rng=np.random.default_rng(5))
                          .sample(16))
    assert not native.available()
    assert np.array_equal(jf, tf)
    assert np.abs(np.asarray(jx, np.float32)
                  - np.asarray(tx, np.float32)).max() > 1e-3


# --- the experiment's services ---------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def test_repr_fn_matches_jax(pair):
    from types import SimpleNamespace
    from ctvae_tpu.training.experiment import VAEXperiment as JExperiment
    from ctvae_torch.training import VAEXperiment
    jm, variables, tm = pair
    jexp = JExperiment(jm, {}, None)
    jexp.state = SimpleNamespace(params=variables["params"], model_state={})
    exp = VAEXperiment(tm, {}, None)
    x, _, _ = batch(3, B=5)
    for inp in (x, np.clip(x * 255, 0, 255).astype(np.uint8)):
        want = np.asarray(jexp.repr_fn(inp))
        got = exp.repr_fn(inp)
        assert got.shape == want.shape == (5, SMALL["embedding_dim"] * 16)
        close(t2n(got), want)


def test_run_train_adds_the_jax_metric_keys(tmp_path, monkeypatch):
    """``run.train`` of ``configs/synthetic_ct.yaml`` with
    ``exp_params.metrics``: the validation's ``val_`` metric keys are those
    the JAX ``run.py`` adds (its ``MetricSet`` over the same dataset's
    ``_full_data``), finite, and in ``scalars.jsonl``. TSynthetic's grid
    dataset has no fixed-factor sampling, so FactorVaeScore is left out,
    as it would raise in both packages."""
    from ctvae_tpu.data.datamodule import VAEDataset as JData
    from ctvae_tpu.metrics import MetricSet as JSet
    from ctvae_torch import run
    from ctvae_torch.config import read_config
    monkeypatch.chdir(tmp_path)
    cfg = read_config(os.path.join(REPO, "configs", "synthetic_ct.yaml"))
    names = ["DCI", "MIG", "SAP"]
    cfg["exp_params"] = {**cfg["exp_params"], "metrics": names}
    out = run.train(cfg, device="cpu")
    jdata = JData(**cfg["data_params"])
    jdata.setup()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JSet(names, jdata.val_dataset._full_data, batch_size=8,
                    num_train=16, num_test=8).compute(
            lambda x: np.asarray(x).reshape(len(x), -1)[:, :16])
    metric_keys = {k for k in out if k.startswith("val_")
                   and "." in k}
    assert metric_keys == {"val_" + k for k in want}
    assert all(np.isfinite(out[k]) for k in metric_keys)
    run_dir = tmp_path / "logs" / "CTMCQVAE" / "version_0"
    logged = {}
    for line in open(run_dir / "scalars.jsonl"):
        logged.update(json.loads(line))
    assert metric_keys <= set(logged)


def _jax_watch_step(jm, variables, mode, b, monkeypatch, exp):
    """One jitted JAX ``make_train_step(watch_modules=True)``: its metrics
    and recorded draws."""
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    params = variables["params"]
    tx = jopt.build_optimizers(exp, params, 4)[0]
    state = jstate.TrainState(step=jnp.array(0, jnp.int32), params=params,
                              model_state={}, opt_states=(tx.init(params),),
                              rng=jax.random.PRNGKey(21))
    step = jax.jit(jstate.make_train_step(
        jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
        static_fwd_kwargs={"mode": mode}, watch_modules=True))
    with recorded_draws(monkeypatch, seed=21) as rec:
        _, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return jax.device_get(metrics), rec.draws


@pytest.mark.parametrize("exp", [
    dict(LR=5e-4, scheduler_gamma=0.994, weight_decay=0.0),
    dict(LR=5e-4, weight_decay=0.0, update_parameters="ct_layer",
         gradient_clip_val=0.5)], ids=["all", "ct_layer_clipped"])
def test_watch_norms_match_jax(monkeypatch, pair, exp):
    import copy
    from ctvae_torch.training import optimizers as topt
    from ctvae_torch.training import state as tstate
    jm, variables, tm0 = pair
    tm = copy.deepcopy(tm0)
    x, y, a = batch(11)
    b = {"image": x, "input_y": y, "action": a}
    want, draws = _jax_watch_step(jm, variables, "causal", b, monkeypatch,
                                  exp)
    replay = ReplayDraws(draws)
    monkeypatch.setattr(tstate, "Draws", lambda gen, device: replay)
    state = tstate.create_train_state(tm, topt.build_optimizers(exp, tm, 4))
    got = tstate.make_train_step("causal", watch_modules=True)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    watch = {k for k in want if k.startswith(("grad_norm/", "param_norm/"))}
    assert len(watch) == 8 and watch <= set(got)
    for k in sorted(watch):
        close(t2n(got[k]), want[k], atol=0, rtol=1e-5)


def test_watch_gradients_cadence(tmp_path):
    """``exp_params.watch_gradients`` N logs the per-module norms every N
    steps, apart from the ``log_every`` lines."""
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.logging import ExperimentLogger
    data = VAEDataset(dataset_name="TSynthetic", train_batch_size=8,
                      val_batch_size=8, patch_size=16, limit=24,
                      val_limit=8)
    data.setup()
    model = build_model(dict(SMALL), device="cpu")
    logger = ExperimentLogger(save_dir=str(tmp_path), name="w")
    exp = VAEXperiment(model, dict(LR=5e-4, watch_gradients=4), data,
                       logger=logger, log_every=3)
    exp.setup(seed=0)
    exp.train_epoch(0)
    logger.finish()
    rows = [json.loads(line) for line in open(
        os.path.join(logger.log_dir, "scalars.jsonl"))]
    steps = {}
    for r in rows:
        steps.setdefault(r["step"], set()).update(r)
    assert "grad_norm/ct_layer" in steps[4] and "loss" not in steps[4]
    assert "loss" in steps[3] and "grad_norm/ct_layer" not in steps[3]
    assert "param_norm/encoder" in steps[8]


def _state(seed):
    from ctvae_torch.models import build_model
    from ctvae_torch.training import build_optimizers, create_train_state
    model = build_model(dict(SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, build_optimizers({"LR": 1e-3}, model),
                              seed=seed)


def test_async_checkpoint_equals_sync_bytes(tmp_path):
    from ctvae_torch.utils.checkpoint import CheckpointManager
    sync = CheckpointManager(str(tmp_path / "sync"))
    asy = CheckpointManager(str(tmp_path / "async"), async_save=True)
    for i, seed in enumerate((1, 2, 3)):
        state = _state(seed)
        metrics = {"val_Reconstruction_Loss": 1.0 / (i + 1)}
        sync.save(state, 5 + i, metrics=metrics)
        asy.save(state, 5 + i, metrics=metrics)
        # the host copy is taken before save returns: training on is safe
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    asy.wait()
    names = sorted(os.listdir(tmp_path / "sync"))
    assert names == sorted(os.listdir(tmp_path / "async")) == [
        "index.json", "last", "step_6", "step_7"]
    for name in ("last", "step_6", "step_7"):
        assert (tmp_path / "sync" / name).read_bytes() == (
            tmp_path / "async" / name).read_bytes()
    idx = [json.loads((tmp_path / d / "index.json").read_text())
           for d in ("sync", "async")]
    assert [e["step"] for e in idx[0]["best"]] == [
        e["step"] for e in idx[1]["best"]] == [7, 6]


def test_async_checkpoint_raises_a_failed_write(tmp_path, monkeypatch):
    from ctvae_torch.utils import checkpoint
    cm = checkpoint.CheckpointManager(str(tmp_path), async_save=True)

    def boom(blob, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", boom)
    cm.save(_state(0), 1)
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    cm.wait()                      # reported once


def test_profile_writes_a_trace_of_epoch_0(tmp_path):
    from ctvae_torch.data import VAEDataset
    from ctvae_torch.models import build_model
    from ctvae_torch.training import VAEXperiment
    from ctvae_torch.utils.checkpoint import CheckpointManager
    data = VAEDataset(dataset_name="TSynthetic", train_batch_size=8,
                      val_batch_size=8, patch_size=16, limit=8, val_limit=8)
    data.setup()
    trace_dir = tmp_path / "trace"
    exp = VAEXperiment(build_model(dict(SMALL), device="cpu"),
                       dict(LR=5e-4, profile=str(trace_dir),
                            async_checkpointing=True), data,
                       ckpt_manager=CheckpointManager(
                           str(tmp_path / "ckpt"), async_save=True))
    exp.fit(2, seed=0)
    assert os.listdir(trace_dir) == ["epoch_0.pt.trace.json"]
    trace = json.loads((trace_dir / "epoch_0.pt.trace.json").read_text())
    assert any("conv" in e.get("name", "") for e in trace["traceEvents"])
    # fit joined the asynchronous write before it returned
    assert exp.ckpt._pending is None
    assert os.path.exists(tmp_path / "ckpt" / "last")
