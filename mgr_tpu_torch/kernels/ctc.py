"""Wrappers of kernels K3 and K4, the CTC forward recursion (with its
optional alpha store) and its adjoint (``csrc/ctc_fwd.cu`` replaces
``mgr_tpu/ops/pallas_kernels.py:_ctc_fwd_kernel``; ``csrc/ctc_bwd.cu``
replaces ``_ctc_bwd_kernel``), and :class:`CTCAlphaLoss`, the autograd
Function that pairs them as the custom VJP ``ctc_alpha_loss`` pairs the
Pallas kernels.

A CPU tensor goes to the plain versions in ``ops.ctc``; a CUDA tensor
launches the kernel or raises. On the card the stored alphas are views
(T, B, w) of buffers whose rows are :func:`alpha_pitch` floats apart (w
rounded up to a multiple of 4), so that K4 stages each row with one bulk
copy; K4 copies alphas of another layout into that one first.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from mgr_tpu_torch.kernels import build
from mgr_tpu_torch.ops import ctc as _ctc
from mgr_tpu_torch.ops import dispatch

NAME = "ctc_fwd"
BWD_NAME = "ctc_bwd"


def _lib(name: str, n_ptrs: int) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def alpha_pitch(width: int) -> int:
    """Floats between two rows of a stored alpha array of ``width``
    columns on the card (``csrc/ctc_common.cuh``)."""
    return (width + 3) // 4 * 4


def _pitched_empty(T: int, B: int, width: int, device) -> torch.Tensor:
    return torch.empty((T, B, alpha_pitch(width)), dtype=torch.float32,
                       device=device)[..., :width]


def _pitched(alpha: torch.Tensor) -> torch.Tensor:
    """``alpha`` (T, B, w) in K4's layout: f32, rows alpha_pitch(w) floats
    apart, 16-byte aligned; itself where it is so already (K3's store),
    else a copy."""
    T, B, w = alpha.shape
    p = alpha_pitch(w)
    if (alpha.dtype == torch.float32 and alpha.stride() == (B * p, p, 1)
            and alpha.data_ptr() % 16 == 0):
        return alpha
    return _pitched_empty(T, B, w, alpha.device).copy_(alpha)


def launch_shape(name: str, N: int, K: int) -> dict:
    """The launch of K3 (``name`` = "ctc_fwd") or K4 ("ctc_bwd") at N
    labels and K classes: threads per block, frames per staged chunk and
    dynamic shared memory in bytes, as the C entry computes them."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch_shape")
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    build.check(lib, name, fn(N, K, *(ctypes.byref(o) for o in out)), f"{name}_launch_shape")
    return dict(zip(("threads", "chunk_frames", "smem_bytes"), (o.value for o in out)))


def _check(log_probs_tm, labels, blank, name) -> None:
    T, B, K = log_probs_tm.shape
    if labels.shape[0] != B or not 0 <= blank < K:
        raise ValueError(
            f"{name}: labels {tuple(labels.shape)} / blank {blank} "
            f"do not fit log-probs {tuple(log_probs_tm.shape)}"
        )


def _operands(log_probs_tm, labels, input_lengths, label_lengths, name):
    """The kernels' operands (f32 / int32, contiguous), device and stream."""
    B, N = labels.shape
    if N + 1 > 1024:
        raise ValueError(f"{name} takes at most 1023 labels, got {N}")
    dev = log_probs_tm.device
    return (
        log_probs_tm.to(torch.float32).contiguous(),
        labels.to(torch.int32).contiguous(),
        input_lengths.to(torch.int32).reshape(B).contiguous(),
        label_lengths.to(torch.int32).reshape(B).contiguous(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )


def ctc_alpha_loss(
    log_probs_tm: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int,
    *,
    store_alphas: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """K3: per-sequence CTC negative log-likelihood (B,) f32, and with
    ``store_alphas`` the post-step alphas alpha_phi (T, B, N+1) and
    alpha_emit (T, B, N) f32 that K4 reads (on the card, views of
    row-pitched buffers).

    log_probs_tm (T, B, K) time-major log-probabilities; labels (B, N)
    padded with -1; lengths (B,)."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    _check(log_probs_tm, labels, blank, NAME)
    if not dispatch.on_card(log_probs_tm, labels, input_lengths, label_lengths):
        return _ctc.ctc_alpha_loss_plain(
            log_probs_tm, labels, input_lengths, label_lengths, blank,
            store_alphas=store_alphas,
        )
    lp, lab, il, ll, index, stream = _operands(
        log_probs_tm, labels, input_lengths, label_lengths, NAME)
    dev = lp.device
    loss = torch.empty((B,), dtype=torch.float32, device=dev)
    a_phi = a_emit = None
    if store_alphas:
        a_phi = _pitched_empty(T, B, N + 1, dev)
        a_emit = _pitched_empty(T, B, N, dev)
    lib = _lib(NAME, 7)
    err = lib.ctc_fwd(
        lp.data_ptr(), lab.data_ptr(), il.data_ptr(), ll.data_ptr(),
        loss.data_ptr(),
        a_phi.data_ptr() if store_alphas else None,
        a_emit.data_ptr() if store_alphas else None,
        T, B, K, N, blank, index, stream,
    )
    build.check(lib, NAME, err)
    dispatch.count_launch(NAME)
    return (loss, a_phi, a_emit) if store_alphas else loss


def ctc_alpha_bwd(
    log_probs_tm: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int,
    alpha_phi: torch.Tensor,
    alpha_emit: torch.Tensor,
    g_phi: torch.Tensor,
    g_emit: torch.Tensor,
) -> torch.Tensor:
    """K4: d log_probs (T, B, K) f32 from the post-step alphas and the
    loss's seeds g_phi (B,) at phi[L] and g_emit (B,) at emit[L-1]."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    _check(log_probs_tm, labels, blank, BWD_NAME)
    if alpha_phi.shape != (T, B, N + 1) or alpha_emit.shape != (T, B, N):
        raise ValueError(
            f"ctc_alpha_bwd: alphas {tuple(alpha_phi.shape)}, "
            f"{tuple(alpha_emit.shape)} do not fit {(T, B, N)}"
        )
    tensors = (log_probs_tm, labels, input_lengths, label_lengths,
               alpha_phi, alpha_emit, g_phi, g_emit)
    if not dispatch.on_card(*tensors):
        return _ctc.ctc_alpha_bwd_plain(
            log_probs_tm, labels, input_lengths, label_lengths, blank,
            alpha_phi, alpha_emit, g_phi, g_emit,
        )
    lp, lab, il, ll, index, stream = _operands(
        log_probs_tm, labels, input_lengths, label_lengths, BWD_NAME)
    a_phi, a_emit = _pitched(alpha_phi), _pitched(alpha_emit)
    gp, ge = (x.to(torch.float32).contiguous() for x in (g_phi, g_emit))
    dlp = torch.empty((T, B, K), dtype=torch.float32, device=lp.device)
    lib = _lib(BWD_NAME, 9)
    err = lib.ctc_bwd(
        lp.data_ptr(), lab.data_ptr(), il.data_ptr(), ll.data_ptr(),
        a_phi.data_ptr(), a_emit.data_ptr(), gp.data_ptr(), ge.data_ptr(),
        dlp.data_ptr(), T, B, K, N, blank, index, stream,
    )
    build.check(lib, BWD_NAME, err)
    dispatch.count_launch(BWD_NAME)
    return dlp


class CTCAlphaLoss(torch.autograd.Function):
    """``(log_probs_tm, labels, input_lengths, label_lengths, blank) ->
    loss (B,)``, differentiable in log_probs_tm: K3 with the alpha store
    forward, K4 backward (``pallas_kernels.py:622-687``). The backward
    seeds ``-dloss exp(phi_end - logp)`` at phi[L] and ``-dloss
    exp(emit_end - logp)`` at emit[L-1] (only the phi seed where L = 0),
    with logp = -loss and the ends read from the last frame's alphas,
    which are frozen at each sequence's length."""

    @staticmethod
    def forward(ctx, log_probs_tm, labels, input_lengths, label_lengths, blank):
        loss, a_phi, a_emit = ctc_alpha_loss(
            log_probs_tm, labels, input_lengths, label_lengths, blank,
            store_alphas=True,
        )
        ctx.save_for_backward(log_probs_tm, labels, input_lengths, label_lengths,
                              a_phi, a_emit, loss)
        ctx.blank = blank
        return loss

    @staticmethod
    def backward(ctx, dloss):
        lp, labels, il, ll, a_phi, a_emit, loss = ctx.saved_tensors
        B, N = labels.shape
        rows = torch.arange(B, device=lp.device)
        L = ll.to(torch.int64).reshape(B).clamp(0, N)
        logp = -loss
        phi_end = a_phi[-1][rows, L]
        emit_end = a_emit[-1][rows, (L - 1).clamp_min(0)] if N else logp
        dloss = dloss.to(torch.float32)
        g_phi = -dloss * torch.exp(phi_end - logp)
        g_emit = torch.where(L > 0, -dloss * torch.exp(emit_end - logp), 0.0)
        dlp = ctc_alpha_bwd(lp, labels, il, ll, ctx.blank, a_phi, a_emit, g_phi, g_emit)
        return dlp.to(lp.dtype), None, None, None, None
