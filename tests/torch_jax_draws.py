"""JAX's noise and dropout draws replayed in the port, for the parity tests.

JAX's key streams (threefry) cannot be reproduced in torch (Philox), so a
test that compares draws substitutes the port's ``prng.bernoulli`` /
``prng.normal`` with ``jax.random`` draws on the same fold path: a port
key is the path itself, replayed here through ``mgr_tpu.core.prng``. The
production path has no masks argument.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgr_tpu.core import prng as jprng
from mgr_tpu_torch.core import prng


def jax_key(key: prng.Key):
    """The JAX key on the same fold path as a port key."""
    k = jprng.root_key(key.seed)
    for e in key.path:
        k = jprng.fold_name(k, e) if isinstance(e, str) else jax.random.fold_in(k, e)
    return k


def jax_bernoulli(key: prng.Key, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli`` on the port key's fold path."""
    return np.array(jax.random.bernoulli(jax_key(key), p, tuple(shape)))


def jax_normal(key: prng.Key, shape) -> np.ndarray:
    """``jax.random.normal`` (f32) on the port key's fold path."""
    return np.array(jax.random.normal(jax_key(key), tuple(shape), jnp.float32))


def replay_jax_draws(monkeypatch, *, with_shape: bool = False) -> list:
    """Route the port's draws through ``jax.random`` on the same paths for
    the rest of the test; returns the list of (kind, path) drawn, or
    (kind, path, shape) with ``with_shape``."""
    calls = []

    def note(kind, key, shape):
        calls.append((kind, key.path, tuple(shape)) if with_shape else (kind, key.path))

    def bernoulli(key, p, shape, device="cpu"):
        note("bernoulli", key, shape)
        return torch.from_numpy(jax_bernoulli(key, p, shape))

    def normal(key, shape, dtype, device="cpu"):
        note("normal", key, shape)
        assert dtype == torch.float32
        return torch.from_numpy(jax_normal(key, shape))

    monkeypatch.setattr(prng, "bernoulli", bernoulli)
    monkeypatch.setattr(prng, "normal", normal)
    return calls


@pytest.fixture
def jax_streams(monkeypatch):
    """:func:`replay_jax_draws` for the test; the list of (kind, path)."""
    return replay_jax_draws(monkeypatch)
