"""Shared fixtures of the ``test_torch_*`` parity tests: a small CT-MCQ-VAE
config, JAX weights converted into the port, and random draws replayed
on both sides.

JAX and PyTorch give different numbers from one seed, so the tests make
every draw with numpy: while the JAX model is traced, ``jax.random.gumbel``
/ ``uniform`` / ``bernoulli`` (flax's dropout calls the last through
``jax.random`` at call time) / ``normal`` / ``randint`` (``sample`` and
``walk``) / ``cauchy`` are replaced by a recorder that hands out numpy
draws of the requested shape (constants of the jitted program); the
port's ``ReplayDraws`` provider then hands out the same arrays in the same
order (and checks kind and shape). ``jax.random.gamma`` takes a shape per
element that may be a traced value (GammaVAE's ``alpha + gamma_shape``):
the recorder draws numpy's ``standard_gamma`` of it in a
``jax.pure_callback`` when the program runs, into a slot it records in
trace order. FactorVAE's ``permute_latent`` draws one permutation per
row with ``jax.random.permutation`` under ``jax.vmap``, where a recorder
called once at trace time would hand every row the same one: the
recorder replaces ``ctvae_tpu.models.fvae.permute_latent`` itself, with
an independent numpy permutation of the latent dims per row (``[B, D]``,
the ``take_along_axis`` of the JAX function), replayed by
``ReplayDraws.permutation``. The JAX side runs under ``jax.jit``: one
compile of the whole forward costs far less on the CPU than running it
op by op.
"""

from __future__ import annotations

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the replay provider lives in the JAX-free module the data-parallel
# tests' rank processes import
from torch_dp_ranks import GammaSlot, ReplayDraws  # noqa: F401

# small widths: img 16, hidden [8, 16], embedding 8, 2 codebooks, N = 8,
# A = 8, discoverer hidden 16 and one GNN layer of 8
SMALL = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8, action_dim=8,
             hidden_dims=[8, 16], num_embeddings=8, img_size=16, codebooks=2,
             causal_hidden_dims=[16, 8], beta=0.1, gamma=1.5, c_alpha=0.01,
             c_beta=0.4, c_delta=0.01, c_epsilon=0.1, noise="off")

# the MCQVAE of the same backbone (the two-stage recipe's first stage)
MCQ = dict(name="MCQVAE", in_channels=3, embedding_dim=8, hidden_dims=[8, 16],
           num_embeddings=8, img_size=16, codebooks=2, beta=0.1)

ATOL, RTOL = 1e-5, 1e-4   # default value tolerance (f32 on both sides)


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for the test: the small models train fastest
    so, and test workers that each take a thread per core oversubscribe
    the CPU and slow torch's parallel loops by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def _jax_native_lib(tmp_path_factory):
    """The JAX package's C++ transform library, built once per process
    into a temporary directory with that module's own ``_build``."""
    from ctvae_tpu import native
    out = tmp_path_factory.mktemp("jax_native") / "libctvae_native.so"
    path = native._build(out=str(out))
    assert path, "g++ could not build ctvae_tpu/native/transform_kernels.cpp"
    return native._bind(path)


@pytest.fixture
def jax_native(monkeypatch, _jax_native_lib):
    """Pin the JAX package's data path to its native float transform for
    the test. ``ctvae_tpu.native`` loads its library at first use and
    falls back to PIL (which rounds to uint8) when the load fails, as it
    can where parallel test processes build it at once; the port copies
    the native path, so that path is the reference."""
    from ctvae_tpu import native
    monkeypatch.setattr(native, "_lib", _jax_native_lib)
    monkeypatch.setattr(native, "_tried", True)
    return native


def jax_rngs(seed: int = 0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return dict(zip(("params", "gumbel", "noise", "dropout"), keys))


class DrawRecorder:
    """Stands in for ``jax.random.gumbel`` / ``uniform`` / ``bernoulli``
    and records the numpy draws it hands out."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws = []
        self.orig = {"gumbel": jax.random.gumbel,
                     "uniform": jax.random.uniform,
                     "bernoulli": jax.random.bernoulli}

    def normal(self, key, shape=(), dtype=jnp.float32, **kw):
        a = self.rng.standard_normal(size=tuple(shape)).astype(np.float32)
        self.draws.append(("normal", a))
        return jnp.asarray(a, dtype)

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32, **kw):
        a = self.rng.integers(int(minval), int(maxval), size=tuple(shape))
        self.draws.append(("randint", a))
        return jnp.asarray(a, dtype)

    def gumbel(self, key, shape=(), dtype=jnp.float32, **kw):
        a = self.rng.gumbel(size=tuple(shape)).astype(np.float32)
        self.draws.append(("gumbel", a))
        return jnp.asarray(a, dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0, **kw):
        if sys._getframe(1).f_code.co_qualname.startswith("_uniform_init"):
            # the codebook initialiser, which flax's apply traces to check
            # the param's shape: not a draw of the forward
            return self.orig["uniform"](key, shape, dtype, minval, maxval,
                                        **kw)
        a = self.rng.uniform(minval, maxval,
                             size=tuple(shape)).astype(np.float32)
        self.draws.append(("uniform", a))
        return jnp.asarray(a, dtype)

    def bernoulli(self, key, p=0.5, shape=None, **kw):
        shape = np.shape(p) if shape is None else tuple(shape)
        a = self.rng.uniform(size=shape) < float(p)
        self.draws.append(("bernoulli", a))
        return jnp.asarray(a)

    def cauchy(self, key, shape=(), dtype=jnp.float32, **kw):
        a = self.rng.standard_cauchy(size=tuple(shape)).astype(np.float32)
        self.draws.append(("cauchy", a))
        return jnp.asarray(a, dtype)

    def permute_latent(self, key, z):
        """``ctvae_tpu.models.fvae.permute_latent``: each row of z [B, D]
        gathered by its own permutation of range(D)."""
        B, D = z.shape
        perms = np.stack([self.rng.permutation(D) for _ in range(B)])
        self.draws.append(("permutation", perms))
        return jnp.take_along_axis(z, jnp.asarray(perms), axis=1)

    def gamma(self, key, a, shape=None, dtype=jnp.float32, **kw):
        a = jnp.asarray(a, dtype)
        shape = a.shape if shape is None else tuple(shape)
        slot = GammaSlot(shape)
        self.draws.append(("gamma", slot))

        def draw(alpha):
            alpha = np.broadcast_to(np.asarray(alpha, np.float64), shape)
            slot.value = self.rng.standard_gamma(alpha).astype(np.float32)
            return slot.value
        return jax.pure_callback(draw, jax.ShapeDtypeStruct(shape, dtype), a)


@contextlib.contextmanager
def recorded_draws(monkeypatch, seed: int = 0):
    rec = DrawRecorder(seed)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "gumbel", rec.gumbel)
        m.setattr(jax.random, "uniform", rec.uniform)
        m.setattr(jax.random, "bernoulli", rec.bernoulli)
        m.setattr(jax.random, "normal", rec.normal)
        m.setattr(jax.random, "randint", rec.randint)
        m.setattr(jax.random, "cauchy", rec.cauchy)
        m.setattr(jax.random, "gamma", rec.gamma)
        from ctvae_tpu.models import fvae
        m.setattr(fvae, "permute_latent", rec.permute_latent)
        yield rec


def close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def batch(seed: int, B: int = 3, cfg=SMALL):
    """Images x, input_y in [0, 1] (NHWC) and one-hot actions."""
    rng = np.random.default_rng(seed)
    s = cfg["img_size"]
    x = rng.uniform(size=(B, s, s, 3)).astype(np.float32)
    y = rng.uniform(size=(B, s, s, 3)).astype(np.float32)
    a = np.eye(cfg["action_dim"], dtype=np.float32)[
        rng.integers(0, cfg["action_dim"], B)]
    return x, y, a


def keep_grads():
    """An optax transform that passes updates on and keeps them as its
    state: the raw gradients of the step."""
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def jax_train_step(jm, variables, mode, b, monkeypatch, seed, exp):
    """One jitted ``make_train_step`` of the JAX package (optimizer chain
    of ``exp`` behind ``keep_grads``) on batch ``b``, its draws recorded.
    Returns (updated params, raw gradients, metrics, draws)."""
    return jax_train_step_state(jm, variables, mode, b, monkeypatch, seed,
                                exp)[:4]


def jax_train_step_state(jm, variables, mode, b, monkeypatch, seed, exp,
                         M_N=1.0, step=0,
                         fwd_kwargs_keys=("action", "input_y")):
    """``jax_train_step`` whose state also holds the variables' other
    collections (an EMA codebook's ``vq_stats``, BatchNorm's
    ``batch_stats``); returns them updated as a fifth item. ``M_N`` is the
    step's KL weight, ``step`` the state's global step and
    ``fwd_kwargs_keys`` the batch keys the forward takes."""
    import optax

    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    params = variables["params"]
    model_state = {k: v for k, v in variables.items() if k != "params"}
    tx = optax.chain(keep_grads(), jopt.build_optimizers(exp, params, 4)[0])
    state = jstate.TrainState(step=jnp.array(step, jnp.int32),
                              params=params, model_state=model_state,
                              opt_states=(tx.init(params),),
                              rng=jax.random.PRNGKey(seed))
    step_fn = jax.jit(jstate.make_train_step(
        jm, [tx], M_N=M_N, fwd_kwargs_keys=fwd_kwargs_keys,
        static_fwd_kwargs={"mode": mode}))
    with recorded_draws(monkeypatch, seed=seed) as rec:
        new, metrics = step_fn(state, b)
    return (jax.device_get(new.params), jax.device_get(new.opt_states[0][0]),
            jax.device_get(metrics), rec.draws,
            jax.device_get(new.model_state))


def keep_step_grads(n_steps: int):
    """An optax transform that passes updates on and keeps each of
    ``n_steps`` steps' in its state ([n_steps, ...] per leaf, at the
    step's index): the raw gradients of every step of a scan."""
    import optax

    def init(p):
        return (jnp.zeros((), jnp.int32), jax.tree_util.tree_map(
            lambda x: jnp.zeros((n_steps,) + x.shape, x.dtype), p))

    def update(u, s, p=None):
        i, kept = s
        return u, (i + 1, jax.tree_util.tree_map(
            lambda k, g: k.at[i].set(g), kept, u))
    return optax.GradientTransformation(init, update)


def jax_multi_train_step(jm, variables, mode, stacked, monkeypatch, seed,
                         exp, n_steps):
    """``make_multi_train_step(n_steps=n_steps)`` of the JAX package, jitted,
    on ``stacked`` batches ([n_steps, B, ...]), the optimizer chain of
    ``exp`` behind ``keep_step_grads``; the scan body is traced once, so
    its recorded draws are those of every step. Returns (updated params,
    each step's raw gradients as a list of trees, the last step's
    metrics, draws)."""
    import optax

    from ctvae_tpu.training import optimizers as jopt
    from ctvae_tpu.training import state as jstate
    params = variables["params"]
    tx = optax.chain(keep_step_grads(n_steps),
                     jopt.build_optimizers(exp, params, 4)[0])
    state = jstate.TrainState(step=jnp.array(0, jnp.int32), params=params,
                              model_state={}, opt_states=(tx.init(params),),
                              rng=jax.random.PRNGKey(seed))
    step = jax.jit(jstate.make_multi_train_step(
        jm, [tx], n_steps=n_steps, M_N=1.0,
        fwd_kwargs_keys=("action", "input_y"),
        static_fwd_kwargs={"mode": mode}))
    with recorded_draws(monkeypatch, seed=seed) as rec:
        new, metrics = step(state, stacked)
    assert int(new.step) == n_steps
    kept = jax.device_get(new.opt_states[0][0][1])
    grads = [jax.tree_util.tree_map(lambda g: g[i], kept)
             for i in range(n_steps)]
    return jax.device_get(new.params), grads, jax.device_get(metrics), \
        rec.draws


def assert_steps_match(tm, j_params, j_grads, grads, lr):
    """``assert_step_matches`` over n steps: each step's gradient leaf
    (``grads[k]``, the port's by name) within 1e-5 x max(1, max |g|) of
    JAX's (``j_grads[k]``), and each parameter after the n-th update
    within n (2e-6 + ``lr`` / 1e-8 times the sum over the steps of its
    gradient's difference). Each update's first and second moments are
    means of the steps' gradients so far, so one update moves at most lr /
    1e-8 times the largest difference among them, and n updates at most
    n times the sum."""
    from ctvae_torch.convert import from_jax_params
    n = len(grads)
    want_p = from_jax_params(j_params, tm)
    diff = {name: torch.zeros_like(p) for name, p in tm.named_parameters()}
    for got, want in zip(grads, j_grads):
        want_g = from_jax_params(want, tm)
        for name, g in got.items():
            scale = max(1.0, float(want_g[name].abs().max()))
            close(t2n(g), want_g[name].numpy(), atol=1e-5 * scale, rtol=0)
            diff[name] += (g - want_g[name]).abs()
    for name, p in tm.named_parameters():
        tol = n * (2e-6 + lr / 1e-8 * diff[name])
        assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), name


def assert_step_matches(tm, j_params, j_grads, lr):
    """Each gradient leaf of the port's model within 1e-5 x max(1, max
    |g|) of JAX's, and each parameter after Adam's first step within 2e-6
    plus ``lr`` / 1e-8 times its gradient's difference: Adam moves a
    parameter by lr g / (|g| + 1e-8), so the gradients' own difference
    bounds the parameters'."""
    from ctvae_torch.convert import from_jax_params
    want_g = from_jax_params(j_grads, tm)
    want_p = from_jax_params(j_params, tm)
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(1.0, float(want_g[name].abs().max()))
        close(t2n(g), want_g[name].numpy(), atol=1e-5 * scale, rtol=0)
        tol = 2e-6 + lr / 1e-8 * (g - want_g[name]).abs()
        assert bool(((p.detach() - want_p[name]).abs() <= tol).all()), name


def build_pair(cfg=SMALL, seed: int = 0):
    """(jax_model, jax_variables, port_model on CPU) with the port's
    weights converted from the JAX init."""
    from ctvae_tpu.models import build_model as jax_build
    from ctvae_torch.convert import from_jax_params
    from ctvae_torch.models import build_model

    jm = jax_build(dict(cfg))
    x, y, a = batch(seed, B=2, cfg=cfg)
    variables = jax.jit(functools.partial(jm.init, mode="action"))(
        jax_rngs(seed), jnp.asarray(x), input_y=jnp.asarray(y),
        action=jnp.asarray(a))
    tm = build_model(dict(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(variables), tm))
    return jm, variables, tm
