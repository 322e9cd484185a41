"""Named, reproducible random streams (``mgr_tpu/core/prng.py``).

JAX derives every key from a seed by a path of folds: a name
(``fold_name``) or an integer (``fold_in``). A :class:`Key` here is that
path itself, and a ``torch.Generator`` on the tensor's device is seeded
from a stable hash of it when a draw is made. So a draw depends only on
the seed and the path, never on what was drawn before: a resumed run
draws the same masks as an unbroken one.

The numbers differ from ``jax.random``'s for the same path (torch's
Philox is not JAX's threefry); tests that hold the port to the JAX
package substitute :func:`bernoulli` and :func:`normal` with draws that
replay the same path through ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class Key:
    seed: int
    path: Tuple[Union[str, int], ...] = ()


def root_key(seed: int) -> Key:
    return Key(int(seed))


def fold_name(key: Key, name: str) -> Key:
    """Sub-stream named ``name``."""
    return Key(key.seed, key.path + (str(name),))


def fold_in(key: Key, data: int) -> Key:
    """Sub-stream number ``data`` (a step, a direction, a microbatch)."""
    return Key(key.seed, key.path + (int(data),))


def generator(key: Key, device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded from a stable 63-bit hash of the
    key (Python's ``hash`` is salted per process, so it is not used)."""
    digest = hashlib.sha256(repr((key.seed, key.path)).encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & (2**63 - 1)
    )


def bernoulli(key: Key, p: float, shape: Tuple[int, ...],
              device: torch.device | str = "cpu") -> torch.Tensor:
    """Bool mask, True with probability ``p`` (``uniform < p``, as
    ``jax.random.bernoulli``)."""
    u = torch.rand(shape, generator=generator(key, device), device=device)
    return u < p


def normal(key: Key, shape: Tuple[int, ...], dtype: torch.dtype,
           device: torch.device | str = "cpu") -> torch.Tensor:
    """Standard normal draws of ``dtype``."""
    return torch.randn(shape, generator=generator(key, device), dtype=dtype,
                       device=device)
