"""Wrapper of kernel K1, the time-major BiLSTM forward recurrence
(``csrc/bilstm_tm_fwd.cu``; replaces
``mgr_tpu/ops/pallas_kernels.py:_tm_fwd_kernel``).

A CPU tensor goes to ``ops.lstm.bilstm_scan_tm_plain``; a CUDA tensor
launches the kernel or raises. Like ``pallas_bilstm_tm`` the kernel takes
bf16 operands whatever the compute dtype, stores the h stream in bf16
and returns it as f32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from mgr_tpu_torch.kernels import build
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as _lstm

NAME = "bilstm_tm_fwd"


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.bilstm_tm_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bilstm_tm_fwd_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_tm_fwd_error_string.restype = ctypes.c_char_p
    return lib


def bilstm_tm(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    *, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """xp0, xp1 (T, B, 4, H) projections in original time order;
    U (2, H, 4, H). Returns hs0, hs1 (T, B, H) f32 (and cs0, cs1 with
    ``store_c``), direction 1 scanned T-1 -> 0 and stored at original
    positions."""
    T, B, four, H = xp0.shape
    if four != 4 or xp1.shape != xp0.shape or U.shape != (2, H, 4, H):
        raise ValueError(
            f"bilstm_tm: want xp (T,B,4,H) x2 and U (2,H,4,H), got "
            f"{tuple(xp0.shape)}, {tuple(xp1.shape)}, {tuple(U.shape)}"
        )
    if not dispatch.on_card(xp0, xp1, U):
        return _lstm.bilstm_scan_tm_plain(xp0, xp1, U, store_c=store_c)

    # The kernel reads h rows as bf16 pairs: pad an odd H with one dead
    # unit (zero projection and zero weights keep its h at 0).
    Hk = H + (H & 1)
    bf = torch.bfloat16
    xp0k, xp1k, Uk = xp0.to(bf), xp1.to(bf), U.to(bf)
    if Hk != H:
        xp0k, xp1k = (F.pad(x, (0, 1)) for x in (xp0k, xp1k))
        Uk = F.pad(Uk, (0, 1, 0, 0, 0, 1))
    xp0k, xp1k, Uk = (x.contiguous() for x in (xp0k, xp1k, Uk))
    dev = xp0.device
    hs0 = torch.empty((T, B, Hk), dtype=bf, device=dev)
    hs1 = torch.empty_like(hs0)
    cs0 = torch.empty_like(hs0) if store_c else None
    cs1 = torch.empty_like(hs0) if store_c else None
    lib = _lib()
    err = lib.bilstm_tm_fwd(
        xp0k.data_ptr(), xp1k.data_ptr(), Uk.data_ptr(),
        hs0.data_ptr(), hs1.data_ptr(),
        cs0.data_ptr() if store_c else None,
        cs1.data_ptr() if store_c else None,
        T, B, Hk, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, NAME, err)
    dispatch.count_launch(NAME)
    out = (hs0[..., :H].float(), hs1[..., :H].float())
    if store_c:
        out += (cs0[..., :H].float(), cs1[..., :H].float())
    return out
