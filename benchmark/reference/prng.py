"""Named random streams: a frozen copy of the key arithmetic the port's
``core/prng.py`` defines, so that the reference draws the same noise and
dropout masks from the same keys.

A key is a seed and a path of folds (names and integers). A draw seeds a
``torch.Generator`` on the tensor's device from a SHA-256 of the key and
draws with ``torch.rand`` / ``torch.randn``: the same key, shape, dtype
and device give the same values.
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


def fold_name(key: Key, name: str) -> Key:
    return Key(key.seed, key.path + (str(name),))


def fold_in(key: Key, data: int) -> Key:
    return Key(key.seed, key.path + (int(data),))


def generator(key: Key, device) -> torch.Generator:
    digest = hashlib.sha256(repr((key.seed, key.path)).encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & (2**63 - 1))


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """True with probability p: ``uniform < p``."""
    return torch.rand(shape, generator=generator(key, device), device=device) < p


def normal(key: Key, shape, device) -> torch.Tensor:
    """Standard normal f32 draws."""
    return torch.randn(shape, generator=generator(key, device), dtype=torch.float32,
                       device=device)
