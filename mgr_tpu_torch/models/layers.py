"""Shared layer primitives: dense, Gaussian noise, dropout, the CNN
frontend of the RGB stream.

Counterpart of ``mgr_tpu/models/layers.py``. Kernels are
RandomUniform(-0.05, 0.05), biases zero. Noise and dropout draw from
``core.prng`` keys in train mode and are the identity otherwise; on the
GSPMD route they draw at the global shape and take this rank's rows and
time slice (``ops.dispatch.draw_local``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgr_tpu_torch.core import prng, tracing
from mgr_tpu_torch.core.config import CNNConfig
from mgr_tpu_torch.ops import dispatch
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
    x: torch.Tensor, stddev: float, rng: Optional[prng.Key], train: bool, *,
    batch_axis: int = 0, time_axis: Optional[int] = None,
) -> torch.Tensor:
    """Keras GaussianNoise: ``x + stddev * N(0, 1)`` in x's dtype, train
    mode only. ``batch_axis`` is x's batch axis and ``time_axis`` its time
    axis where x may be a rank's time slice (``dispatch.draw_local``)."""
    if not train or stddev == 0.0:
        return x
    if rng is None:
        raise ValueError("gaussian_noise requires an rng in train mode")
    noise = dispatch.draw_local(lambda s: prng.normal(rng, s, x.dtype, x.device),
                                tuple(x.shape), batch_axis=batch_axis, time_axis=time_axis)
    return x + stddev * noise


def dropout(
    x: torch.Tensor, rate: float, rng: Optional[prng.Key], train: bool, *,
    batch_axis: int = 0, time_axis: Optional[int] = None,
) -> torch.Tensor:
    """Inverted dropout ``x * mask / keep``, computed in x's dtype as JAX
    does (the scalar keep converted to that dtype). The axes as in
    :func:`gaussian_noise`."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout requires an rng in train mode")
    keep = 1.0 - rate
    mask = dispatch.draw_local(lambda s: prng.bernoulli(rng, keep, s, x.device),
                               tuple(x.shape), batch_axis=batch_axis, time_axis=time_axis)
    return x * mask.to(x.dtype) / torch.tensor(keep, dtype=x.dtype, device=x.device)


class Dense(nn.Module):
    """Trainable parameters ``W (in, out)`` and ``b (out,)``, keyed as in
    the JAX pytree (``head.W`` <-> ``params["head"]["W"]``)."""

    def __init__(self, params: Params):
        super().__init__()
        self.W = nn.Parameter(params["W"])
        self.b = nn.Parameter(params["b"])

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return dense({"W": self.W, "b": self.b}, x, compute_dtype)


# ---------------------------------------------------------------------------
# CNN frontend (RGB stream): three conv blocks 16@5x5 / 32@5x5 / 48@4x4,
# VALID, each followed by relu and a 2x2 max-pool, over every frame at once
# (T folded into the batch), as ``mgr_tpu/models/layers.py:71-123``.
# ---------------------------------------------------------------------------


def init_cnn(generator: torch.Generator, cfg: CNNConfig, in_channels: int = 1) -> Params:
    """``conv_i`` (k, k, c_in, c_out) in JAX's HWIO layout and ``bias_i``
    (c_out,) zeros, for each block."""
    params: Params = {}
    c_in = in_channels
    for i, (c_out, k) in enumerate(zip(cfg.channels, cfg.kernel_sizes)):
        params[f"conv_{i}"] = (torch.rand((k, k, c_in, c_out), generator=generator) * 2.0
                               - 1.0) * KERNEL_SCALE
        params[f"bias_{i}"] = torch.zeros((c_out,), dtype=torch.float32)
        c_in = c_out
    return params


def cnn_output_dim(cfg: CNNConfig) -> int:
    """Features a frame of ``cfg.img_dim`` pixels gives after the conv
    stack, flattened (768 for the rgb preset: 60 -> 56 -> 28 -> 24 -> 12 ->
    9 -> 4, times 48 channels)."""
    d = cfg.img_dim
    for k, p in zip(cfg.kernel_sizes, cfg.pool_sizes):
        d = (d - k + 1) // p
    return d * d * cfg.channels[-1]


def _ieee_f32():
    """cuDNN with TF32 off, the other flags as they are: an f32 conv is
    then an f32 conv, as the JAX package's is, whatever the caller set
    globally (PyTorch lets cuDNN convs use TF32 by default)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                   allow_tf32=False)


class _ConvValid(torch.autograd.Function):
    """``x (N, C, H, W) * w (O, C, k, k)``, stride 1, VALID, no bias, in
    the operands' dtype; forward and backward under :func:`_ieee_f32`
    (autograd would run the backward outside any context the forward set)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _ieee_f32():
            return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw


def cnn_frontend(params: Params, x: torch.Tensor, cfg: CNNConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, H, W, C) video -> (B, T, D) f32 frame features.

    T is folded into the batch and the frames cast to the compute dtype.
    Each block convolves channels-last (NHWC memory) with its HWIO kernel
    cast to the compute dtype and laid out OIHW, into a compute-dtype
    output; then adds the bias cast to the compute dtype, in that dtype
    (not inside the conv's f32 sums, which would round once where JAX
    rounds twice), applies relu and a ``p`` x ``p`` max-pool (floor: VALID
    ``reduce_window``). The features are flattened in (h, w, c) order, as
    JAX flattens NHWC."""
    B, T, H, W, C = x.shape
    with tracing.annotate("mgr.cnn.frontend"):
        y = x.reshape(B * T, H, W, C).to(compute_dtype).permute(0, 3, 1, 2)
        for i, p in enumerate(cfg.pool_sizes):
            w = params[f"conv_{i}"].to(compute_dtype).permute(3, 2, 0, 1)
            y = _ConvValid.apply(y, w.contiguous(memory_format=torch.channels_last))
            y = F.relu(y + params[f"bias_{i}"].to(compute_dtype)[:, None, None])
            y = F.max_pool2d(y, p)  # floor: a partial edge window dropped, as VALID drops it
        return y.permute(0, 2, 3, 1).reshape(B, T, -1).float()


class CNN(nn.Module):
    """The frontend's trainable parameters ``conv_i`` (HWIO) and ``bias_i``,
    keyed as in the JAX pytree (``cnn.conv_0`` <-> ``params["cnn"]["conv_0"]``)."""

    def __init__(self, params: Params, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return cnn_frontend(dict(self.named_parameters()), x, self.cfg, compute_dtype)
