"""Wrappers of kernels K1 and K2, the time-major BiLSTM recurrence and its
adjoint (``csrc/bilstm_tm_fwd.cu`` replaces
``mgr_tpu/ops/pallas_kernels.py:_tm_fwd_kernel``; ``csrc/bilstm_tm_bwd.cu``
replaces ``_tm_bwd_kernel``), and :class:`BiLSTMTm`, the autograd
Function that pairs them as ``_tm_core`` pairs the Pallas kernels.

K5a and K5b, the single-direction recurrence and its adjoint of the
direction-sharded tensor-parallel path, are the entries ``lstm_tm_fwd``
and ``lstm_tm_bwd`` of the same two sources (replacing
``_tm1_fwd_kernel`` and ``_tm1_bwd_kernel``): :func:`lstm_tm_streams`,
:func:`lstm_tm_bwd` and the autograd Function :class:`LSTMTm`, the
counterpart of ``_tm1_core``.

A CPU tensor goes to the plain versions in ``ops.lstm``; a CUDA tensor
launches the kernel or raises. Like ``pallas_bilstm_tm`` the kernels take
bf16 operands whatever the compute dtype and keep the h and c streams in
bf16.

K1's and K2's sources run in one of two tilings, which :func:`batch_groups`
chooses for both from the shape and the card: one batch group (8-unit
slices over all rows) or two (16-unit slices, each block gathering its own
group's rows). A row's h, c and dz do not depend on the tiling.
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
BWD_NAME = "bilstm_tm_bwd"
ONE_NAME = "lstm_tm_fwd"
ONE_BWD_NAME = "lstm_tm_bwd"


# The recurrences' tiling: two batch groups from this many rows on
# (:func:`batch_groups`). Up to 32 rows (B=1, rgb's 16, the preset's 32) K1
# and K2 keep the one-group tiling those paths were measured with, though
# two groups timed faster at every B from 32 to 256 on an H100 (PERF.md §6).
GROUPED_MIN_B = 33


def grid_blocks(H: int, groups: int, dirs: int = 2) -> int:
    """Blocks of a K1 or K2 launch (``csrc/bilstm_tm_{fwd,bwd}.cu``) at
    width H: directions x batch groups x unit slices, a slice 8 units in
    one group and 16 in two."""
    return dirs * groups * -(-H // (8 if groups == 1 else 16))


def batch_groups(B: int, H: int, sms: int, dirs: int = 2) -> int:
    """Batch groups of a K1 or K2 launch (and their K5/K6 entries) over B
    rows at width H and ``dirs`` directions on a card of ``sms`` SMs: 2
    from GROUPED_MIN_B rows on, where the grid of two groups fits one block
    an SM (the launch is cooperative); else 1. Two groups halve the rows
    whose h (K1) or dz (K2) each block gathers a step, and let K1 stage them
    in one round. Their shared memory fits every H the kernels take (at
    most 230,400 bytes, K2 at H=512), so the SM count is the only
    fallback."""
    if B < GROUPED_MIN_B or grid_blocks(H, 2, dirs) > sms:
        return 1
    return 2


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _lib(entry: str, n_ptrs: int, n_ints: int = 4) -> ctypes.CDLL:
    """The library of ``entry``'s source, with ``entry``'s C signature:
    ``n_ptrs`` pointers (the last is the barrier scratch), ``n_ints`` ints,
    the stream."""
    source = dispatch.SOURCES[entry]
    lib = build.load(source)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    words = getattr(lib, f"{source}_barrier_words")
    words.argtypes = [ctypes.c_int] * 2  # B, groups
    words.restype = ctypes.c_int
    return lib


def _barrier(lib: ctypes.CDLL, entry: str, B: int, device: torch.device,
             groups: int) -> torch.Tensor:
    """The split barrier's counters for one call of ``entry`` at batch B in
    ``groups`` batch groups: zeroed int32 words on ``device`` (a counter per
    direction, group and launch), fresh for every call, so no call sees
    another's."""
    n = getattr(lib, f"{dispatch.SOURCES[entry]}_barrier_words")(B, groups)
    return torch.zeros(n, dtype=torch.int32, device=device)


def _device_and_stream(t: torch.Tensor):
    dev = t.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _even(*streams: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """bf16 contiguous operands. The kernels read rows as bf16 pairs: pad
    an odd H with one dead unit (zero projection, weights and streams keep
    it at 0)."""
    out = []
    for x in streams:
        x = x.to(torch.bfloat16)
        if x.shape[-1] & 1:
            x = F.pad(x, (0, 1))
        out.append(x.contiguous())
    return tuple(out)


def _even_u(U: torch.Tensor) -> torch.Tensor:
    """U (D, H, 4, H) as :func:`_even`, padded on both H axes."""
    U = U.to(torch.bfloat16)
    if U.shape[-1] & 1:
        U = F.pad(U, (0, 1, 0, 0, 0, 1))
    return U.contiguous()


def _check_shapes(name: str, xp0, xp1, U) -> Tuple[int, int, int]:
    T, B, four, H = xp0.shape
    if four != 4 or xp1.shape != xp0.shape or U.shape != (2, H, 4, H):
        raise ValueError(
            f"{name}: want xp (T,B,4,H) x2 and U (2,H,4,H), got "
            f"{tuple(xp0.shape)}, {tuple(xp1.shape)}, {tuple(U.shape)}"
        )
    return T, B, H


def bilstm_tm_streams(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    *, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """K1: the stored streams hs0, hs1 (and cs0, cs1 with ``store_c``),
    (T, B, H) each, direction 1 scanned T-1 -> 0 and stored at original
    positions. bf16 from the kernel; in the compute dtype (xp's) from the
    plain version."""
    T, B, H = _check_shapes("bilstm_tm", xp0, xp1, U)
    if not dispatch.on_card(xp0, xp1, U):
        return _lstm.bilstm_scan_tm_plain(
            xp0, xp1, U, store_c=store_c, out_dtype=xp0.dtype)
    xp0k, xp1k = _even(xp0, xp1)
    Uk = _even_u(U)
    Hk = xp0k.shape[-1]
    dev = xp0.device
    bf = torch.bfloat16
    hs0 = torch.empty((T, B, Hk), dtype=bf, device=dev)
    hs1 = torch.empty_like(hs0)
    cs0 = torch.empty_like(hs0) if store_c else None
    cs1 = torch.empty_like(hs0) if store_c else None
    groups = batch_groups(B, Hk, _sms(xp0))
    lib = _lib(NAME, 8, 5)
    err = lib.bilstm_tm_fwd(
        xp0k.data_ptr(), xp1k.data_ptr(), Uk.data_ptr(),
        hs0.data_ptr(), hs1.data_ptr(),
        cs0.data_ptr() if store_c else None,
        cs1.data_ptr() if store_c else None,
        _barrier(lib, NAME, B, dev, groups).data_ptr(),
        T, B, Hk, groups, *_device_and_stream(xp0),
    )
    build.check(lib, NAME, err)
    dispatch.count_launch(NAME, grouped=groups > 1)
    out = (hs0, hs1) + ((cs0, cs1) if store_c else ())
    return tuple(s[..., :H] for s in out)


def bilstm_tm(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    *, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """xp0, xp1 (T, B, 4, H) projections in original time order;
    U (2, H, 4, H). Returns hs0, hs1 (T, B, H) f32 (and cs0, cs1 with
    ``store_c``), direction 1 scanned T-1 -> 0 and stored at original
    positions."""
    return tuple(s.float() for s in bilstm_tm_streams(xp0, xp1, U, store_c=store_c))


def bilstm_tm_bwd(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    hs0: torch.Tensor, hs1: torch.Tensor, cs0: torch.Tensor, cs1: torch.Tensor,
    dhs0: torch.Tensor, dhs1: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: dz0, dz1 (T, B, 4, H), the gate adjoints of both directions,
    from the forward's operands, its stored streams (T, B, H) and the
    streams' cotangents (T, B, H). bf16 from the kernel; in the compute
    dtype from the plain version."""
    T, B, H = _check_shapes("bilstm_tm_bwd", xp0, xp1, U)
    for s in (hs0, hs1, cs0, cs1, dhs0, dhs1):
        if s.shape != (T, B, H):
            raise ValueError(f"bilstm_tm_bwd: want streams {(T, B, H)}, got {tuple(s.shape)}")
    if not dispatch.on_card(xp0, xp1, U, hs0, hs1, cs0, cs1, dhs0, dhs1):
        return _lstm.bilstm_scan_tm_bwd_plain(
            xp0, xp1, U, hs0, hs1, cs0, cs1, dhs0, dhs1)[:2]
    xp0k, xp1k = _even(xp0, xp1)
    Uk = _even_u(U)
    streams = _even(hs0, hs1, cs0, cs1, dhs0, dhs1)
    Hk = xp0k.shape[-1]
    dz0 = torch.empty((T, B, 4, Hk), dtype=torch.bfloat16, device=xp0.device)
    dz1 = torch.empty_like(dz0)
    groups = batch_groups(B, Hk, _sms(xp0))
    lib = _lib(BWD_NAME, 12, 5)
    err = lib.bilstm_tm_bwd(
        xp0k.data_ptr(), xp1k.data_ptr(), Uk.data_ptr(),
        *(s.data_ptr() for s in streams), dz0.data_ptr(), dz1.data_ptr(),
        _barrier(lib, BWD_NAME, B, xp0.device, groups).data_ptr(),
        T, B, Hk, groups, *_device_and_stream(xp0),
    )
    build.check(lib, BWD_NAME, err)
    dispatch.count_launch(BWD_NAME, grouped=groups > 1)
    return dz0[..., :H], dz1[..., :H]


class BiLSTMTm(torch.autograd.Function):
    """``(xp0, xp1, U) -> (hs0, hs1)`` f32, differentiable in all three:
    K1 forward with the c streams stored, K2 backward, and the
    recurrent-weight gradient as one GEMM outside the kernel
    (``_tm_core`` / ``_tm_core_bwd``, ``pallas_kernels.py:1002-1031``).

    The forward saves the streams as stored (bf16 on the card), not f32
    copies. The backward rounds the cotangents to the stream dtype before
    K2 (``:1015``), returns dxp = dz in xp's dtype (``:1028``) and dU
    rounded through the stream dtype, as JAX rounds it to the bf16 U the
    kernel was given (``:1027``)."""

    @staticmethod
    def forward(ctx, xp0, xp1, U):
        hs0, hs1, cs0, cs1 = bilstm_tm_streams(xp0, xp1, U, store_c=True)
        ctx.save_for_backward(xp0, xp1, U, hs0, hs1, cs0, cs1)
        return hs0.float(), hs1.float()

    @staticmethod
    def backward(ctx, g0, g1):
        xp0, xp1, U, hs0, hs1, cs0, cs1 = ctx.saved_tensors
        sd = hs0.dtype
        dz0, dz1 = bilstm_tm_bwd(xp0, xp1, U, hs0, hs1, cs0, cs1, g0.to(sd), g1.to(sd))
        dU = _lstm.recurrent_weight_grad(hs0, hs1, dz0, dz1)
        return dz0.to(xp0.dtype), dz1.to(xp1.dtype), dU.to(sd).to(U.dtype)


def _check_one(name: str, xp, U1) -> Tuple[int, int, int]:
    T, B, four, H = xp.shape
    if four != 4 or U1.shape != (H, 4, H):
        raise ValueError(
            f"{name}: want xp (T,B,4,H) and U1 (H,4,H), got "
            f"{tuple(xp.shape)}, {tuple(U1.shape)}")
    return T, B, H


def lstm_tm_streams(
    xp: torch.Tensor, U1: torch.Tensor, *, reverse: bool, store_c: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """K5a: one direction's stored stream hs (and cs with ``store_c``),
    (T, B, H), scanned T-1 -> 0 when ``reverse`` and stored at original
    positions. xp (T, B, 4, H) in original time order, U1 (H, 4, H). bf16
    from the kernel; in the compute dtype (xp's) from the plain version."""
    T, B, H = _check_one("lstm_tm", xp, U1)
    if not dispatch.on_card(xp, U1):
        return _lstm.lstm_scan_tm_plain(
            xp, U1, reverse=reverse, store_c=store_c, out_dtype=xp.dtype)
    (xpk,) = _even(xp)
    Uk = _even_u(U1)
    Hk = xpk.shape[-1]
    hs = torch.empty((T, B, Hk), dtype=torch.bfloat16, device=xp.device)
    cs = torch.empty_like(hs) if store_c else None
    groups = batch_groups(B, Hk, _sms(xp), dirs=1)
    lib = _lib(ONE_NAME, 5, 6)
    err = lib.lstm_tm_fwd(
        xpk.data_ptr(), Uk.data_ptr(), hs.data_ptr(),
        cs.data_ptr() if store_c else None,
        _barrier(lib, ONE_NAME, B, xp.device, groups).data_ptr(),
        T, B, Hk, int(reverse), groups, *_device_and_stream(xp),
    )
    build.check(lib, NAME, err, ONE_NAME)
    dispatch.count_launch(ONE_NAME, grouped=groups > 1)
    return tuple(s[..., :H] for s in ((hs, cs) if store_c else (hs,)))


def lstm_tm_bwd(
    xp: torch.Tensor, U1: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: torch.Tensor, *, reverse: bool,
) -> torch.Tensor:
    """K5b: dz (T, B, 4, H), one direction's gate adjoints, from the
    forward's operands, its stored streams (T, B, H) and the h stream's
    cotangent (T, B, H); ``reverse`` as the forward ran. bf16 from the
    kernel; in the compute dtype from the plain version."""
    T, B, H = _check_one("lstm_tm_bwd", xp, U1)
    for s in (hs, cs, dhs):
        if s.shape != (T, B, H):
            raise ValueError(f"lstm_tm_bwd: want streams {(T, B, H)}, got {tuple(s.shape)}")
    if not dispatch.on_card(xp, U1, hs, cs, dhs):
        return _lstm.lstm_scan_tm_bwd_plain(xp, U1, hs, cs, dhs, reverse=reverse)[0]
    (xpk,) = _even(xp)
    Uk = _even_u(U1)
    streams = _even(hs, cs, dhs)
    Hk = xpk.shape[-1]
    dz = torch.empty((T, B, 4, Hk), dtype=torch.bfloat16, device=xp.device)
    groups = batch_groups(B, Hk, _sms(xp), dirs=1)
    lib = _lib(ONE_BWD_NAME, 7, 6)
    err = lib.lstm_tm_bwd(
        xpk.data_ptr(), Uk.data_ptr(), *(s.data_ptr() for s in streams), dz.data_ptr(),
        _barrier(lib, ONE_BWD_NAME, B, xp.device, groups).data_ptr(),
        T, B, Hk, int(reverse), groups, *_device_and_stream(xp),
    )
    build.check(lib, BWD_NAME, err, ONE_BWD_NAME)
    dispatch.count_launch(ONE_BWD_NAME, grouped=groups > 1)
    return dz[..., :H]


class LSTMTm(torch.autograd.Function):
    """``(xp, U1, reverse) -> hs`` f32, differentiable in xp and U1: K5a
    forward with the c stream stored, K5b backward, and the recurrent-weight
    gradient as one GEMM outside the kernel (``_tm1_core`` /
    ``_tm1_core_bwd``, ``pallas_kernels.py:1270-1297``).

    As :class:`BiLSTMTm`: the cotangent is rounded to the stream dtype
    before K5b (``:1284``), dxp = dz is returned in xp's dtype, and dU,
    summed in f32 from operands in dz's dtype, is rounded through the
    stream dtype to U1's dtype (``:1292-1294``). A reverse scan's
    pre-state is at t+1, zero at T-1 (``:1286-1291``)."""

    @staticmethod
    def forward(ctx, xp, U1, reverse):
        hs, cs = lstm_tm_streams(xp, U1, reverse=reverse, store_c=True)
        ctx.reverse = reverse
        ctx.save_for_backward(xp, U1, hs, cs)
        return hs.float()

    @staticmethod
    def backward(ctx, g):
        xp, U1, hs, cs = ctx.saved_tensors
        sd = hs.dtype
        dz = lstm_tm_bwd(xp, U1, hs, cs, g.to(sd), reverse=ctx.reverse)
        dU = _lstm.lstm_weight_grad(hs, dz, reverse=ctx.reverse)
        return dz.to(xp.dtype), dU.to(sd).to(U1.dtype), None
