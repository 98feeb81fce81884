"""Shared fixtures of the ``test_torch_*`` parity tests: a small CT-MCQ-VAE
config, JAX weights converted into the port, and random draws replayed
on both sides.

JAX and PyTorch give different numbers from one seed, so the tests make
every draw with numpy: while the JAX model is traced, ``jax.random.gumbel``
/ ``jax.random.uniform`` are replaced by a recorder that hands out numpy
draws of the requested shape (constants of the jitted program); the
port's ``ReplayDraws`` provider then hands out the same arrays in the same
order (and checks kind and shape). The JAX side runs under ``jax.jit``:
one compile of the whole forward costs far less on the CPU than running
it op by op.
"""

from __future__ import annotations

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

# small widths: img 16, hidden [8, 16], embedding 8, 2 codebooks, N = 8,
# A = 8, discoverer hidden 16 and one GNN layer of 8
SMALL = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8, action_dim=8,
             hidden_dims=[8, 16], num_embeddings=8, img_size=16, codebooks=2,
             causal_hidden_dims=[16, 8], beta=0.1, gamma=1.5, c_alpha=0.01,
             c_beta=0.4, c_delta=0.01, c_epsilon=0.1, noise="off")

ATOL, RTOL = 1e-5, 1e-4   # default value tolerance (f32 on both sides)


def jax_rngs(seed: int = 0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return dict(zip(("params", "gumbel", "noise", "dropout"), keys))


class DrawRecorder:
    """Stands in for ``jax.random.gumbel`` / ``uniform`` and records the
    numpy draws it hands out."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws = []
        self.orig = {"gumbel": jax.random.gumbel,
                     "uniform": jax.random.uniform}

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


@contextlib.contextmanager
def recorded_draws(monkeypatch, seed: int = 0):
    rec = DrawRecorder(seed)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "gumbel", rec.gumbel)
        m.setattr(jax.random, "uniform", rec.uniform)
        yield rec


class ReplayDraws:
    """The port's draw provider, replaying a ``DrawRecorder``'s arrays."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        assert self.draws, f"port drew one more {kind} than JAX"
        k, a = self.draws.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, a.shape, kind,
                                                       tuple(shape))
        return torch.from_numpy(a.copy())

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def done(self):
        return not self.draws


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
