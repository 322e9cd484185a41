"""Shared layer primitives: dense, Gaussian noise, dropout.

Counterpart of ``mgr_tpu/models/layers.py``. Kernels are
RandomUniform(-0.05, 0.05), biases zero. Noise and dropout draw from
``core.prng`` keys in train mode and are the identity otherwise. The
CNN frontend (RGB) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mgr_tpu_torch.core import prng
from mgr_tpu_torch.ops.lstm import matmul_f32

Params = Dict[str, torch.Tensor]

KERNEL_SCALE = 0.05


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    W = (torch.rand((in_dim, out_dim), generator=generator) * 2.0 - 1.0) * KERNEL_SCALE
    return {"W": W, "b": torch.zeros((out_dim,), dtype=torch.float32)}


def dense(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Operands in the compute dtype, f32 sums, f32 bias: f32 output."""
    return matmul_f32(x.to(compute_dtype), params["W"].to(compute_dtype)) + params["b"]


def gaussian_noise(
    x: torch.Tensor, stddev: float, rng: Optional[prng.Key], train: bool
) -> torch.Tensor:
    """Keras GaussianNoise: ``x + stddev * N(0, 1)`` in x's dtype, train
    mode only."""
    if not train or stddev == 0.0:
        return x
    if rng is None:
        raise ValueError("gaussian_noise requires an rng in train mode")
    return x + stddev * prng.normal(rng, tuple(x.shape), x.dtype, x.device)


def dropout(
    x: torch.Tensor, rate: float, rng: Optional[prng.Key], train: bool
) -> torch.Tensor:
    """Inverted dropout ``x * mask / keep``, computed in x's dtype as JAX
    does (the scalar keep converted to that dtype)."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout requires an rng in train mode")
    keep = 1.0 - rate
    mask = prng.bernoulli(rng, keep, tuple(x.shape), x.device).to(x.dtype)
    return x * mask / torch.tensor(keep, dtype=x.dtype, device=x.device)


class Dense(nn.Module):
    """Trainable parameters ``W (in, out)`` and ``b (out,)``, keyed as in
    the JAX pytree (``head.W`` <-> ``params["head"]["W"]``)."""

    def __init__(self, params: Params):
        super().__init__()
        self.W = nn.Parameter(params["W"])
        self.b = nn.Parameter(params["b"])

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return dense({"W": self.W, "b": self.b}, x, compute_dtype)
