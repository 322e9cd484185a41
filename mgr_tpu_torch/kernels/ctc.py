"""Wrapper of kernel K3, the CTC forward recursion and loss
(``csrc/ctc_fwd.cu``; replaces
``mgr_tpu/ops/pallas_kernels.py:_ctc_fwd_kernel``).

A CPU tensor goes to ``ops.ctc.ctc_alpha_loss_plain``; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mgr_tpu_torch.kernels import build
from mgr_tpu_torch.ops import ctc as _ctc
from mgr_tpu_torch.ops import dispatch

NAME = "ctc_fwd"


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ctc_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ctc_fwd_error_string.argtypes = [ctypes.c_int]
    lib.ctc_fwd_error_string.restype = ctypes.c_char_p
    return lib


def ctc_alpha_loss(
    log_probs_tm: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int,
) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood (B,) f32.

    log_probs_tm (T, B, K) time-major log-probabilities; labels (B, N)
    padded with -1; lengths (B,)."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    if labels.shape[0] != B or not 0 <= blank < K:
        raise ValueError(
            f"ctc_alpha_loss: labels {tuple(labels.shape)} / blank {blank} "
            f"do not fit log-probs {tuple(log_probs_tm.shape)}"
        )
    if not dispatch.on_card(log_probs_tm, labels, input_lengths, label_lengths):
        return _ctc.ctc_alpha_loss_plain(
            log_probs_tm, labels, input_lengths, label_lengths, blank
        )
    if N + 1 > 1024:
        raise ValueError(f"ctc_fwd takes at most 1023 labels, got {N}")
    lp = log_probs_tm.to(torch.float32).contiguous()
    lab = labels.to(torch.int32).contiguous()
    il = input_lengths.to(torch.int32).reshape(B).contiguous()
    ll = label_lengths.to(torch.int32).reshape(B).contiguous()
    dev = lp.device
    loss = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.ctc_fwd(
        lp.data_ptr(), lab.data_ptr(), il.data_ptr(), ll.data_ptr(),
        loss.data_ptr(), T, B, K, N, blank,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, NAME, err)
    dispatch.count_launch(NAME)
    return loss
