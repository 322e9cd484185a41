"""Wrappers of kernels K6a and K6b, the batch-major LSTM scan of D
directions and its adjoint (the entry ``lstm_scan_fwd`` of
``csrc/bilstm_tm_fwd.cu`` replaces ``mgr_tpu/ops/pallas_kernels.py:
_fwd_kernel``; ``lstm_scan_bwd`` of ``csrc/bilstm_tm_bwd.cu`` replaces
``_bwd_kernel``), and :class:`LSTMScan`, the autograd Function that pairs
them as ``_scan_core`` pairs the Pallas kernels.

Every direction scans forward over its own projection (the caller flipped
direction 1's input). The kernels read the (D, B, T, 4, H) projection and
write the (D, B, T, H) streams in place, so no layout copy surrounds them
(``pallas_recurrent_scan`` moves time to the front and back). A CPU tensor
goes to the plain versions in ``ops.lstm``; a CUDA tensor launches the
kernel or raises. Like ``pallas_recurrent_scan`` the kernels take bf16
operands whatever the compute dtype and keep the h and c streams in bf16.
Nothing is padded but an odd H's one dead unit (as for K1): the TPU's
padding of T at the end of a forward scan touches no real output.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mgr_tpu_torch.kernels import build
from mgr_tpu_torch.kernels import bilstm_tm as _k1  # its build and operand helpers
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as _lstm

NAME = "lstm_scan_fwd"
BWD_NAME = "lstm_scan_bwd"


def _check(name: str, xp: torch.Tensor, U: torch.Tensor) -> Tuple[int, int, int, int]:
    if xp.dim() != 5 or xp.shape[0] not in (1, 2) or xp.shape[3] != 4 or \
            U.shape != (xp.shape[0], xp.shape[4], 4, xp.shape[4]):
        raise ValueError(
            f"{name}: want xp (D,B,T,4,H) with D in (1, 2) and U (D,H,4,H), got "
            f"{tuple(xp.shape)}, {tuple(U.shape)}")
    D, B, T, _, H = xp.shape
    return D, B, T, H


def lstm_scan_streams(
    xp: torch.Tensor, U: torch.Tensor, *, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """K6a: the stored streams hs (and cs with ``store_c``), (D, B, T, H),
    every direction scanned t = 0 -> T-1. xp (D, B, T, 4, H), U (D, H, 4,
    H). bf16 from the kernel; in the compute dtype (xp's) from the plain
    version."""
    D, B, T, H = _check("lstm_scan", xp, U)
    if not dispatch.on_card(xp, U):
        return _lstm.recurrent_scan_plain(xp, U, store_c=store_c, out_dtype=xp.dtype)
    (xpk,) = _k1._even(xp)
    Uk = _k1._even_u(U)
    Hk = xpk.shape[-1]
    hs = torch.empty((D, B, T, Hk), dtype=torch.bfloat16, device=xp.device)
    cs = torch.empty_like(hs) if store_c else None
    groups = _k1.batch_groups(B, Hk, _k1._sms(xp), dirs=D)
    lib = _k1._lib(NAME, 5, 6)
    err = lib.lstm_scan_fwd(
        xpk.data_ptr(), Uk.data_ptr(), hs.data_ptr(),
        cs.data_ptr() if store_c else None,
        _k1._barrier(lib, NAME, B, xp.device, groups).data_ptr(),
        D, T, B, Hk, groups, *_k1._device_and_stream(xp),
    )
    build.check(lib, dispatch.SOURCES[NAME], err, NAME)
    dispatch.count_launch(NAME, grouped=groups > 1)
    return tuple(s[..., :H] for s in ((hs, cs) if store_c else (hs,)))


def lstm_scan_bwd(
    xp: torch.Tensor, U: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: torch.Tensor,
) -> torch.Tensor:
    """K6b: dz (D, B, T, 4, H), the gate adjoints of every direction, from
    the forward's operands, its stored streams (D, B, T, H) and the h
    streams' cotangent (D, B, T, H). bf16 from the kernel; in the compute
    dtype from the plain version."""
    D, B, T, H = _check("lstm_scan_bwd", xp, U)
    for s in (hs, cs, dhs):
        if s.shape != (D, B, T, H):
            raise ValueError(f"lstm_scan_bwd: want streams {(D, B, T, H)}, got {tuple(s.shape)}")
    if not dispatch.on_card(xp, U, hs, cs, dhs):
        return _lstm.recurrent_scan_bwd_plain(xp, U, hs, cs, dhs)
    (xpk,) = _k1._even(xp)
    Uk = _k1._even_u(U)
    streams = _k1._even(hs, cs, dhs)
    Hk = xpk.shape[-1]
    dz = torch.empty((D, B, T, 4, Hk), dtype=torch.bfloat16, device=xp.device)
    groups = _k1.batch_groups(B, Hk, _k1._sms(xp), dirs=D)
    lib = _k1._lib(BWD_NAME, 7, 6)
    err = lib.lstm_scan_bwd(
        xpk.data_ptr(), Uk.data_ptr(), *(s.data_ptr() for s in streams), dz.data_ptr(),
        _k1._barrier(lib, BWD_NAME, B, xp.device, groups).data_ptr(),
        D, T, B, Hk, groups, *_k1._device_and_stream(xp),
    )
    build.check(lib, dispatch.SOURCES[BWD_NAME], err, BWD_NAME)
    dispatch.count_launch(BWD_NAME, grouped=groups > 1)
    return dz[..., :H]


class LSTMScan(torch.autograd.Function):
    """``(xp, U) -> hs`` (D, B, T, H) as stored (bf16 on the card),
    differentiable in xp and U: K6a forward with the c streams stored, K6b
    backward, and the recurrent-weight gradient as one GEMM outside the
    kernel (``_scan_core`` / ``_scan_core_fwd`` / ``_scan_core_bwd``,
    ``pallas_kernels.py:312-338``).

    The forward saves the streams as stored. The backward rounds the
    cotangent to the stream dtype before K6b (``:326``), returns dxp = dz
    in xp's dtype, and dU, summed in f32 from operands in dz's dtype,
    rounded through the stream dtype to U's dtype, as JAX rounds it to the
    bf16 U the kernel was given (``:335``)."""

    @staticmethod
    def forward(ctx, xp, U):
        hs, cs = lstm_scan_streams(xp, U, store_c=True)
        ctx.save_for_backward(xp, U, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        xp, U, hs, cs = ctx.saved_tensors
        sd = hs.dtype
        dz = lstm_scan_bwd(xp, U, hs, cs, g.to(sd))
        dU = _lstm.scan_weight_grad(hs, dz)
        return dz.to(xp.dtype), dU.to(sd).to(U.dtype)
