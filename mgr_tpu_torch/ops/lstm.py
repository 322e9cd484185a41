"""Bidirectional LSTM with Keras-2 semantics, time-major (eval path).

Counterpart of ``mgr_tpu/ops/lstm.py``. Same parameters, same layouts,
same numerics:

  * gate order i, f, g, o; ``tanh`` activation; Keras ``hard_sigmoid``
    recurrent activation, ``clamp(0.2 x + 0.5, 0, 1)``. This is NOT
    ``torch.nn.functional.hardsigmoid``, which is ``x / 6 + 0.5``.
  * gate-blocked weights: ``W (2, F, 4, H)``, ``U (2, H, 4, H)``,
    ``b (2, 4, H)``; column ``g * H + j`` of the fused 4H axis is unit j
    of gate g.
  * init: uniform +-0.05 ``W``, one orthogonal ``(H, 4H)`` ``U``
    reshaped to gate-blocked, zero bias with a unit forget bias.
  * the input projection for all time steps is one matmul outside the
    recurrence; matmul operands are in the compute dtype, sums in f32,
    the bias is added in f32 BEFORE the projection is cast to the
    compute dtype (``mgr_tpu/ops/lstm.py:469-472``).
  * carries are f32; the emitted h stream is rounded to the compute
    dtype.

The recurrence itself is kernel K1 (``csrc/bilstm_tm_fwd.cu``) on a CUDA
device and :func:`bilstm_scan_tm_plain` on the CPU, chosen by
``mgr_tpu_torch.kernels.bilstm_tm``. Training (dropout masks, the
backward kernel) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mgr_tpu_torch.kernels import bilstm_tm as _kernel

Params = Dict[str, torch.Tensor]

TRAIN_NOT_PORTED = (
    "training is not ported yet: the BiLSTM backward kernel (K2) and the "
    "train step are ROADMAP.md 'Modules to port', item 7"
)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard_sigmoid: ``clamp(0.2 x + 0.5, 0, 1)``."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def orthogonal(
    rows: int, cols: int, generator: torch.Generator
) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal()`` for a 2-D shape: QR of a
    standard normal matrix, columns sign-fixed by ``diag(R)``."""
    n, m = max(rows, cols), min(rows, cols)
    a = torch.randn((n, m), generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.T.contiguous() if rows < cols else q


def init_lstm_params(
    generator: torch.Generator, in_dim: int, hidden: int,
    kernel_scale: float = 0.05,
) -> Params:
    """One direction, gate-blocked: W (F, 4, H), U (H, 4, H), b (4, H)."""
    W = (
        torch.rand((in_dim, 4, hidden), generator=generator) * 2.0 - 1.0
    ) * kernel_scale
    U = orthogonal(hidden, 4 * hidden, generator).reshape(hidden, 4, hidden)
    b = torch.zeros((4, hidden), dtype=torch.float32)
    b[1] = 1.0  # unit forget-gate bias (Keras unit_forget_bias)
    return {"W": W, "U": U, "b": b}


def init_bilstm_params(
    generator: torch.Generator, in_dim: int, hidden: int,
    kernel_scale: float = 0.05,
) -> Params:
    """Stacked forward/backward parameters with a leading direction axis."""
    fwd = init_lstm_params(generator, in_dim, hidden, kernel_scale)
    bwd = init_lstm_params(generator, in_dim, hidden, kernel_scale)
    return {k: torch.stack([fwd[k], bwd[k]]) for k in fwd}


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 sums and an f32 result, whatever the operands'
    dtype (JAX's ``preferred_element_type=float32``). A library GEMM:
    cuBLAS with an f32 output on the card, an f32 product of the
    (already rounded) operands on the CPU."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


def input_projection(
    x_tm: torch.Tensor, W: torch.Tensor, b: torch.Tensor, compute_dtype
) -> torch.Tensor:
    """One direction's projection: (T, B, F) x (F, 4, H) + (4, H) ->
    (T, B, 4, H) in the compute dtype, bias added in f32 first."""
    F, _, H = W.shape
    xp = matmul_f32(
        x_tm.to(compute_dtype), W.to(compute_dtype).reshape(F, 4 * H)
    )
    return (xp + b.reshape(4 * H)).to(compute_dtype).reshape(
        *x_tm.shape[:-1], 4, H
    )


def bilstm_scan_tm_plain(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    *, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain recurrence: the reference for kernel K1.

    xp0, xp1: (T, B, 4, H) projections in original time order, in the
    compute dtype; U: (2, H, 4, H). Direction 1 walks t = T-1 -> 0.
    Returns hs0, hs1 (T, B, H) f32, each value rounded through the
    compute dtype (the stored h stream), and with ``store_c`` also the
    c streams, rounded the same way."""
    T, B, _, H = xp0.shape
    cd = xp0.dtype
    Uc = U.to(cd).reshape(2, H, 4 * H)
    hs = [torch.empty((T, B, H), dtype=cd, device=xp0.device) for _ in range(2)]
    cs = [torch.empty_like(hs[0]) for _ in range(2)] if store_c else None
    for d, xp in enumerate((xp0, xp1)):
        h = torch.zeros((B, H), dtype=torch.float32, device=xp0.device)
        c = torch.zeros_like(h)
        for s in range(T):
            t = s if d == 0 else T - 1 - s
            z = xp[t].float().reshape(B, 4 * H) + matmul_f32(h.to(cd), Uc[d])
            i = hard_sigmoid(z[:, 0 * H:1 * H])
            f = hard_sigmoid(z[:, 1 * H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            o = hard_sigmoid(z[:, 3 * H:4 * H])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs[d][t] = h.to(cd)
            if store_c:
                cs[d][t] = c.to(cd)
    out = (hs[0].float(), hs[1].float())
    if store_c:
        out += (cs[0].float(), cs[1].float())
    return out


def bilstm_layer_tm(
    params: Params,
    x_tm: torch.Tensor,
    *,
    train: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Time-major bidirectional LSTM, eval mode: (T, B, F) -> (T, B, 2H)
    in the compute dtype (forward half, then backward half)."""
    if train:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    W, U, b = params["W"], params["U"], params["b"]
    xp0 = input_projection(x_tm, W[0], b[0], compute_dtype)
    xp1 = input_projection(x_tm, W[1], b[1], compute_dtype)
    hs0, hs1 = _kernel.bilstm_tm(xp0, xp1, U)
    return torch.cat([hs0, hs1], dim=-1).to(compute_dtype)
