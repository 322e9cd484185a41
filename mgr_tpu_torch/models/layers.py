"""Shared layer primitives: dense, Gaussian noise, dropout.

Counterpart of ``mgr_tpu/models/layers.py`` for the eval path. Kernels
are RandomUniform(-0.05, 0.05), biases zero. The CNN frontend (RGB) is
not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mgr_tpu_torch.ops.lstm import TRAIN_NOT_PORTED, matmul_f32

Params = Dict[str, torch.Tensor]

KERNEL_SCALE = 0.05


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    W = (torch.rand((in_dim, out_dim), generator=generator) * 2.0 - 1.0) * KERNEL_SCALE
    return {"W": W, "b": torch.zeros((out_dim,), dtype=torch.float32)}


def dense(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Operands in the compute dtype, f32 sums, f32 bias: f32 output."""
    return matmul_f32(x.to(compute_dtype), params["W"].to(compute_dtype)) + params["b"]


def gaussian_noise(x: torch.Tensor, stddev: float, train: bool) -> torch.Tensor:
    """Keras GaussianNoise: the identity in eval mode."""
    if train and stddev:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    return x


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Dropout: the identity in eval mode."""
    if train and rate:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    return x


class Dense(nn.Module):
    """Parameters ``W (in, out)`` and ``b (out,)``, keyed as in the JAX
    pytree (``head.W`` <-> ``params["head"]["W"]``)."""

    def __init__(self, params: Params):
        super().__init__()
        self.W = nn.Parameter(params["W"], requires_grad=False)
        self.b = nn.Parameter(params["b"], requires_grad=False)

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return dense({"W": self.W, "b": self.b}, x, compute_dtype)
