"""Training a model at ``dtype: bfloat16`` over ``torch.distributed``
ranks on the CPU: gloo ranks, each its own process
(``tests/torch_dp_ranks.py``, which imports nothing of JAX), under
``exp_params.sharding: dp`` and ``fsdp``, against the JAX package's
bfloat16 train step over a mesh of two data devices (``fsdp_shardings``
at ``fsdp_min_size`` 64, so the CT layer's bfloat16 parameters and their
Adam moments are split there as the port splits them).

- The small CT model, one step per mode, and VanillaVAE (BatchNorm's
  global statistics in float32 beside bfloat16 convolutions), one step,
  with the JAX step's draws and its flip-prone decisions (VQ codes, the
  CT layer's argmax, the sampled edges: ``Taps``) replayed on each of two
  ranks, under DP and under FSDP: the losses within 2 %, ``grad_norm``,
  every gradient leaf and every parameter after Adam as
  tests/test_torch_bf16.py holds one process, against the port's float32
  step on the same values, draws and decisions, with the port's single
  bfloat16 process beside JAX as a reference of bfloat16 rounding
  (``assert_rank_step_matches``), BatchNorm's running statistics within
  4 bfloat16 ulps of their scale. A gradient's bucket is summed over the
  ranks in bfloat16 (gloo and NCCL take bfloat16; at two ranks the sum
  of two bfloat16 values rounded once, the bits of a bfloat16 addition)
  and divided by 2 in bfloat16, which is exact.
- The same action step on four ranks, ``dcn_replicas: 2`` (2 replicas x 2
  data), under FSDP, within the same bounds: there a bucket's sum of four
  bfloat16 values may round after each addition, in gloo's order, where
  one process sums the four rows' terms in float32 inside each
  convolution's or kernel's reduction.
- FSDP's Adam moments hold the slice alone, in the parameter's dtype
  (bfloat16 for the CT layer's own parameters). Generator-drawn runs (two
  steps per mode) on two ranks: the ranks end bit-identical; FSDP with
  nothing split equals DP bit for bit (its ``grad_norm`` adds the leaves'
  squares in one process's order and dtypes); with a clip that bites,
  FSDP's clipped step (``norm_fn``) against DP's (``clip_grad_norm_``).
- ``fit`` under FSDP at bfloat16 with a resume, bit for bit; checkpoints
  moved between FSDP ranks, DP ranks and one process, bit for bit, their
  bfloat16 moments bfloat16 in every file.

JAX runs its XLA paths (no Pallas kernels), as tests/test_torch_fsdp.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctvae_torch.convert import from_jax_params
from test_torch_bf16 import ULP, VAE_SMALL, Taps, _bf16, assert_ulps
from test_torch_parallel import (EXP, FIT, MODES, RANK_TIMEOUT, ROWS, WORLD,
                                 _global_batch, finish, start)
from torch_dp_ranks import run_steps
from torch_port_common import (SMALL, one_torch_thread, port_pair,
                               recorded_draws)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MIN_SIZE = 64                       # fsdp_min_size of the FSDP runs
CLIP = 0.05                         # below every step's grad_norm
CT = _bf16(SMALL)
VAE = _bf16(VAE_SMALL)
LOSSES = {"ct": ("loss", "Reconstruction_Loss", "VQ_Loss", "CT_Loss"),
          "vae": ("loss", "Reconstruction_Loss", "KLD")}


def _f32(state_dict):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in state_dict.items()}


def _jax_mesh_step(jm, variables, mode, b, mp, seed):
    """One JAX train step over a mesh of ``WORLD`` data devices with
    ``fsdp_shardings`` at ``MIN_SIZE`` (``pin_state_shardings``), on the
    global batch split over them, traced here with its draws recorded.
    Returns a function that compiles and runs it (XLA compiles outside
    the GIL, so several can run on threads) and returns (params, raw
    gradients, metrics, draws, the model state after it, the split
    leaves' dtypes)."""
    import optax

    from ctvae_tpu.parallel.mesh import (make_mesh, pin_state_shardings,
                                         put_replicated, shard_batch,
                                         shard_params_fsdp)
    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    from torch_port_common import keep_grads
    mesh = make_mesh(jax.devices()[:WORLD])
    params = variables["params"]
    tx = optax.chain(keep_grads(), jopt.build_optimizers(EXP, params, 4)[0])
    with mesh:
        sp = shard_params_fsdp(params, mesh, min_size=MIN_SIZE)
        state = jstate.TrainState(
            step=put_replicated(jnp.array(0, jnp.int32), mesh), params=sp,
            model_state=put_replicated(
                {k: v for k, v in variables.items() if k != "params"}, mesh),
            opt_states=(tx.init(sp),),
            rng=put_replicated(jax.random.PRNGKey(seed), mesh))
        fn = pin_state_shardings(jstate.make_train_step(
            jm, [tx], M_N=1.0, fwd_kwargs_keys=("action", "input_y"),
            static_fwd_kwargs={"mode": mode}), state)
        batch = shard_batch(b, mesh)
        with recorded_draws(mp, seed=seed) as rec:
            lowered = jax.jit(fn).lower(state, batch)

    def run():
        with mesh:
            new, metrics = lowered.compile()(state, batch)
        split = [leaf.dtype for leaf in jax.tree_util.tree_leaves(new.params)
                 if not leaf.sharding.is_fully_replicated]
        return (jax.device_get(new.params),
                jax.device_get(new.opt_states[0][0]),
                jax.device_get(metrics), rec.draws,
                jax.device_get(new.model_state), split)
    return run


def _dist(a, b) -> float:
    return float((a.double() - b.double()).norm())


def assert_rank_step_matches(got, single, twin, j_params, j_grads, cfg):
    """A rank's bfloat16 step (``got``: its parameters after the step and
    its gradients) against the JAX mesh step, as ``assert_bf16_step_matches``
    (tests/test_torch_bf16.py) holds one process, with two references of
    bfloat16 rounding in place of JAX's alone: JAX's step and the port's
    single process (``single``). JAX on the CPU computes a bfloat16
    elementwise chain in float32 and rounds once, torch rounds every
    operation, so where a gradient cancels (``disc_b2``, a GAT layer's
    bias under its softmax) the port's single process, like its ranks,
    can be further from the float32 step (``twin``) than twice JAX's.

    * Each gradient leaf within twice the further of the two references'
      distances to the float32 step, plus 2 ulps of its norm.
    * A sign of the gradient may differ from JAX's only on an element
      whose float32 gradient is within twice that rounding of zero.
    * Each parameter after Adam's first step (a move of LR g / (|g| +
      1e-8)) within 2 ulps of JAX's, at the scale of the operands (the
      parameter plus LR: a parameter that the step takes near zero rounds
      at its old size), plus 2e-6 and LR times the difference of the two
      sides' g / (|g| + 1e-8)."""
    lr = EXP["LR"]
    tm = _model_after(cfg, got)
    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    for name, p in tm.named_parameters():
        zero = torch.zeros(p.shape, dtype=torch.float64)
        g = got["grads"][-1].get(name, zero).double()
        w = want_g[name].double()
        o = single["grads"][-1].get(name, zero).double()
        r = twin["grads"][-1].get(name, zero).double()
        assert w.dtype == g.dtype and want_g[name].dtype == p.dtype, name
        e_ref = max(_dist(w, r), _dist(o, r))
        assert _dist(g, r) <= 2 * e_ref + 2 * ULP * float(r.norm()), \
            (name, _dist(g, r), _dist(w, r), _dist(o, r))
        noise = 2 * max(float((v - r).abs().max()) for v in (w, o))
        flip = torch.sign(g) != torch.sign(w)
        assert not bool((flip & (r.abs() > noise)).any()), name
        step = (g / (g.abs() + 1e-8) - w / (w.abs() + 1e-8)).abs()
        q = want_p[name].double()
        tol = 2 * ULP * (q.abs() + lr) + 2e-6 + lr * step
        assert bool(((p.detach().double() - q).abs() <= tol).all()), name


def _cases():
    return [("ct", mode) for mode in MODES] + [("vae", "base")]


def _model_after(cfg, res):
    """The port's model of ``cfg`` holding a run's parameters."""
    from ctvae_torch.models import build_model
    tm = build_model(dict(cfg), device="cpu")
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(res["params"][n])
    return tm


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    """The loop's ranks, started first: they run while the JAX steps
    compile."""
    fit_tmp = tmp_path_factory.mktemp("bf16_fit")
    b = _global_batch("ct", 61)
    fit = dict(FIT, cfg=CT, root=str(fit_tmp), fsdp=MIN_SIZE,
               batch={k: v[:ROWS] for k, v in b.items()})
    return start("fsdp_fit", fit, fit_tmp)


def _generator_runs() -> dict:
    """The generator-drawn runs: two steps per mode under DP and under
    FSDP with nothing split; one step per mode with a clip that bites,
    under DP and FSDP."""
    from ctvae_torch.models import build_model
    ct0 = build_model(dict(CT), device="cpu",
                      generator=torch.Generator().manual_seed(2))
    ct = {"cfg": CT, "exp": EXP, "state_dict": ct0.state_dict(),
          "runs": [{"seed": 7 + i, "steps": [
              (mode, _global_batch("ct", 51 + 3 * i + k), None)
              for k in range(2)]} for i, mode in enumerate(MODES)]}
    clip = dict(ct, exp=dict(EXP, gradient_clip_val=CLIP), runs=[
        {"seed": 17 + i, "steps": [(mode, _global_batch("ct", 71 + i), None)]}
        for i, mode in enumerate(MODES)])
    return {"gen_dp": ct, "gen_none": dict(ct, fsdp=1 << 30),
            "clip_dp": clip, "clip_fsdp": dict(clip, fsdp=MIN_SIZE)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, fit_ranks):
    """The JAX mesh step of each case with its draws and decisions
    recorded; the same steps replayed on two DP ranks and two FSDP ranks
    (with the generator-drawn runs, in one launch) and the action step on
    four FSDP ranks of a hybrid mesh; the port's bfloat16 and float32
    steps of each in one process."""
    from concurrent.futures import ThreadPoolExecutor
    pairs = {"ct": port_pair(CT), "vae": port_pair(VAE)}
    mp = pytest.MonkeyPatch()
    runs, batches, taps = {}, {}, {}
    try:
        for i, (name, mode) in enumerate(_cases()):
            jm, variables, _ = pairs[name]
            b = _global_batch("ct" if name == "ct" else "vanilla", 31 + i)
            taps[name, mode], batches[name, mode] = Taps(ordered=False), b
            with mp.context() as m:
                taps[name, mode].jax(m)
                runs[name, mode] = _jax_mesh_step(
                    jm, variables, mode,
                    {k: jnp.asarray(v) for k, v in b.items()}, m,
                    seed=41 + i)
    finally:
        mp.undo()
    with ThreadPoolExecutor(len(runs)) as pool:
        jax_ref = dict(zip(runs, pool.map(lambda run: run(), runs.values())))
    replay = {}
    for case, j in jax_ref.items():
        rec = taps[case].rec
        assert all(a is not None for v in rec.values() for a in v)
        replay[case] = (case[1], batches[case], j[3], copy.deepcopy(rec))

    def spec(name, **kw):
        return {"cfg": CT if name == "ct" else VAE, "exp": EXP,
                "state_dict": pairs[name][2].state_dict(), **kw,
                "runs": [{"steps": [replay[c]]} for c in _cases()
                         if c[0] == name]}
    models = {f"{name}_{kind}": spec(name, **kw) for name in ("ct", "vae")
              for kind, kw in (("dp", {}), ("fsdp", {"fsdp": MIN_SIZE}))}
    ranks = start("steps", {"models": {**models, **_generator_runs()}},
                  tmp_path_factory.mktemp("bf16_replay"))
    hybrid = {"cfg": CT, "exp": EXP, "fsdp": MIN_SIZE, "dcn_replicas": 2,
              "state_dict": pairs["ct"][2].state_dict(),
              "runs": [{"steps": [replay["ct", "action"]]}]}
    hybrid_ranks = start("steps", {"models": {"ct": hybrid}},
                         tmp_path_factory.mktemp("bf16_hybrid"), world=4)
    # the same steps in one process, at bfloat16 and (the reference) at
    # float32 on the same values
    single = {name: run_steps(models[f"{name}_dp"]) for name in ("ct", "vae")}
    twins = {name: run_steps({
        "cfg": dict(s["cfg"], dtype="float32"), "exp": EXP,
        "state_dict": _f32(s["state_dict"]), "runs": s["runs"]})
        for name, s in (("ct", models["ct_dp"]), ("vae", models["vae_dp"]))}
    return {"jax": jax_ref, "single": single, "twins": twins,
            "ranks": finish(ranks),
            "hybrid": finish(hybrid_ranks, timeout=2 * RANK_TIMEOUT)}


def _assert_matches_jax(got, single, twin, j, cfg, kind):
    """One rank's replayed step against the JAX mesh step ``j``, the
    port's float32 step ``twin`` the reference and its bfloat16 single
    process ``single`` a peer of JAX's (``assert_bf16_step_matches``)."""
    j_params, j_grads, j_metrics, _, j_state, _ = j
    metrics = got["metrics"][0]
    for k in LOSSES[kind]:
        assert_ulps(metrics[k], j_metrics[k], ulps=5, scale_ulps=0,
                    rel_scale=1e-6, what=k)
    norms = [torch.as_tensor(np.float64(v)) for v in (
        metrics["grad_norm"], j_metrics["grad_norm"],
        single["metrics"][0]["grad_norm"], twin["metrics"][0]["grad_norm"])]
    gn, wn, on, rn = norms
    assert abs(gn - rn) <= 2 * max(abs(wn - rn), abs(on - rn)) \
        + 2 * ULP * abs(rn), ("grad_norm", norms)
    assert_rank_step_matches(got, single, twin, j_params, j_grads, cfg)
    tm = _model_after(cfg, got)
    if j_state:
        want = from_jax_params({"params": j_params, **j_state}, tm)
        for n, buf in got["buffers"].items():
            if n in want:
                assert buf.dtype == torch.float32, n
                assert_ulps(buf, want[n], ulps=0, scale_ulps=4, what=n)


@pytest.mark.parametrize("sharding", ["dp", "fsdp"])
@pytest.mark.parametrize("name,mode", _cases())
def test_ranks_match_the_jax_mesh_step_at_bf16(steps, name, mode, sharding):
    """Each of two ranks replaying the JAX mesh step of ``mode`` (its rows
    of the draws and decisions) under ``sharding``: losses, ``grad_norm``,
    gradients, parameters after Adam and BatchNorm's statistics against
    JAX's; the two ranks' parameters and buffers equal bit for bit."""
    k = [c for c in _cases() if c[0] == name].index((name, mode))
    cfg = CT if name == "ct" else VAE
    twin, single = steps["twins"][name][k], steps["single"][name][k]
    results = [r[f"{name}_{sharding}"][k] for r in steps["ranks"]]
    for got in results:
        _assert_matches_jax(got, single, twin, steps["jax"][name, mode],
                            cfg, name)
    for part in ("params", "buffers"):
        for n, t in results[0][part].items():
            assert torch.equal(t, results[1][part][n]), (part, n)
    if sharding == "fsdp":
        assert results[0]["axes"]
    if name == "ct":
        # the JAX step split the CT layer's bfloat16 leaves too
        assert jnp.bfloat16 in steps["jax"][name, mode][5]


def test_hybrid_world_of_4_matches_the_jax_mesh_step(steps):
    """Four ranks, ``dcn_replicas: 2``, FSDP over ``data``: the action
    step (a row per rank) against the JAX mesh step as above, the ranks
    bit-identical, the slices equal across the replicas."""
    k = MODES.index("action")
    twin, single = steps["twins"]["ct"][k], steps["single"]["ct"][k]
    results = [r["ct"][0] for r in steps["hybrid"]]
    for got in results:
        _assert_matches_jax(got, single, twin, steps["jax"]["ct", "action"],
                            CT, "ct")
        for n, t in got["params"].items():
            assert torch.equal(t, results[0]["params"][n]), n
    s = [r["slices"] for r in results]
    for n in s[0]:
        assert torch.equal(s[0][n], s[2][n]) and torch.equal(s[1][n],
                                                             s[3][n]), n


# --- generator-drawn runs ---------------------------------------------------

@pytest.fixture(scope="module")
def gen(steps):
    return steps["ranks"]


def test_fsdp_unsplit_is_dp_bit_for_bit_at_bf16(gen):
    """Two steps per mode at bfloat16: the two ranks' parameters and
    buffers equal bit for bit; FSDP with every leaf below
    ``fsdp_min_size`` equals DP bit for bit in every metric
    (``grad_norm`` too), gradient, parameter and buffer."""
    for kind in ("dp", "none"):
        r0, r1 = (r[f"gen_{kind}"] for r in gen)
        for a, b in zip(r0, r1):
            for part in ("params", "buffers"):
                for n, t in a[part].items():
                    assert torch.equal(t, b[part][n]), (kind, part, n)
    for r in gen:
        for got, want in zip(r["gen_none"], r["gen_dp"]):
            assert not got["axes"]
            for m_got, m_want in zip(got["metrics"], want["metrics"]):
                for key, v in m_want.items():
                    assert torch.equal(m_got[key], v), key
            for g_got, g_want in zip(got["grads"], want["grads"]):
                for n, g in g_want.items():
                    assert torch.equal(g_got[n], g), n
            for part in ("params", "buffers"):
                for n, t in want[part].items():
                    assert torch.equal(got[part][n], t), (part, n)


@pytest.mark.parametrize("name", ["ct", "vae"])
def test_fsdp_moments_are_the_slices_in_the_parameters_dtype(steps, name):
    """After the replayed steps, each split parameter's Adam moments have
    its slice's shape and its dtype (bfloat16 for the CT layer's own
    parameters, float32 for the backbones' storage); the bytes resident
    between steps are DP's less half of each split leaf's and of its
    moments', at their element sizes."""
    for r in steps["ranks"]:
        for got, dp in zip(r[f"{name}_fsdp"], r[f"{name}_dp"]):
            assert got["axes"]
            full = {n: p for n, p in got["params"].items()}
            dtypes = got["moment_dtypes"][0]
            assert (name == "ct") == any(
                d[0] == torch.bfloat16 for d in dtypes.values())
            for n, shape in got["moments"][0].items():
                want = list(full[n].shape)
                if n in got["axes"]:
                    want[got["axes"][n]] //= 2
                assert shape == tuple(want), n
                assert dtypes[n] == (full[n].dtype,) * 3, n
            saved = sum(full[n].numel() * full[n].element_size() // 2
                        * (3 if n in dtypes else 1) for n in got["axes"])
            assert got["resident_bytes"] == dp["resident_bytes"] - saved


def test_fsdp_clip_reads_one_process_norm_at_bf16(gen):
    """With ``gradient_clip_val`` below the step's gradient norm, one step
    per mode under FSDP (the CT layer's bfloat16 leaves split) against DP
    ranks, which clip through ``clip_grad_norm_`` on the full gradients:
    ``grad_norm`` within one bfloat16 rounding of a leaf's square sum
    (FSDP adds a split leaf's slices in float32 first), and the parameters
    after the clipped update within 2 ulps at the operands' scale plus
    Adam's reach of the clipped gradients' difference."""
    lr = EXP["LR"]
    for r in gen:
        for got, want in zip(r["clip_fsdp"], r["clip_dp"]):
            assert got["axes"]
            gn, wn = (float(x["metrics"][0]["grad_norm"])
                      for x in (got, want))
            assert wn > 2 * CLIP and abs(gn - wn) <= ULP * wn, (gn, wn)
            for n, p in want["params"].items():
                g = got["grads"][0].get(n, torch.zeros_like(p)).double()
                w = want["grads"][0].get(n, torch.zeros_like(p)).double()
                q = p.double()
                tol = 2 * ULP * (q.abs() + lr) + lr / 1e-8 * (g - w).abs()
                assert bool(((got["params"][n].double() - q).abs()
                             <= tol).all()), n


# --- the loop and checkpoints -----------------------------------------------

@pytest.fixture(scope="module")
def fit(fit_ranks):
    return finish(fit_ranks, timeout=2 * RANK_TIMEOUT)


def test_fsdp_fit_resumes_bit_for_bit_at_bf16(fit):
    """``fit`` under FSDP at bfloat16: rank 0 alone writes; every rank
    restores ``last`` into its slices (equal to what it saved) and trains
    on: the same state, bit for bit, as the epochs without a stop."""
    assert fit[0]["saves"] and not fit[1]["saves"]
    for res in fit:
        assert res["restored_equal"]
        assert res["resumed_step"] == res["straight_step"] > 0
        for n, t in res["straight"].items():
            assert torch.equal(res["resumed"][n], t), n
        assert any(t.dtype == torch.bfloat16 for t in res["resumed"].values())


@pytest.mark.parametrize("src", ["fsdp", "dp", "single"])
def test_bf16_checkpoints_move_between_fsdp_dp_and_one_process(fit, src):
    """A bfloat16 model's checkpoint of an FSDP run, of a DP run or of one
    process (its CT-layer moments bfloat16 in the file) restored into FSDP
    ranks, DP ranks and one process: the state then equals the file's bit
    for bit, dtypes included."""
    for res in fit:
        assert res["file_moment_dtypes"][src] == ["torch.bfloat16",
                                                  "torch.float32"]
        for dst in ("fsdp", "dp", "single"):
            assert res["moves"][f"{src}-{dst}"] == [], dst
