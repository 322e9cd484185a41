"""Bidirectional LSTM with Keras-2 semantics, time-major and batch-major.

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

The recurrence is kernel K1 (``csrc/bilstm_tm_fwd.cu``) on a CUDA device
and :func:`bilstm_scan_tm_plain` on the CPU; its adjoint is kernel K2
(``csrc/bilstm_tm_bwd.cu``) and :func:`bilstm_scan_tm_bwd_plain`, chosen
by ``mgr_tpu_torch.kernels.bilstm_tm``. Under a direction-shard context
(``ops.dispatch.direction_shard``, set by the mesh steps) a layer runs one
direction, through K5a/K5b (:func:`lstm_scan_tm_plain`,
:func:`lstm_scan_tm_bwd_plain` on the CPU), and exchanges the h streams
over the model group (:func:`bilstm_layer_tm_dirsharded`). Under an
H-shard context (``ops.dispatch.h_shard``, set by the mesh steps of the
GSPMD route) a rank projects its time slice with its block of the hidden
units, the time slices are gathered, and the recurrence runs H-sharded
with one exchange of h a step (:func:`bilstm_layer_tm_hsharded`, the
counterpart of the ``lax.scan`` that XLA partitions; no kernel), or
through K1/K2 where the model axis does not divide H. In train mode the
layer's input dropout draws one (B, F) mask per direction (four with
``per_gate``), constant over time, from ``core.prng``
(``mgr_tpu/ops/lstm.py:444-472``).

The batch-major layer API, :func:`bilstm_layer` ((B, T, F) -> (B, T, 2H))
and :func:`lstm_layer` (one direction), projects every direction in one
(D, B, T, 4, H) buffer, direction 1 from the time-flipped input, and runs
:func:`recurrent_scan`: kernel K6a (the entry ``lstm_scan_fwd`` of
``csrc/bilstm_tm_fwd.cu``) with K6b (``lstm_scan_bwd``) as its adjoint on
a CUDA device, chosen by ``mgr_tpu_torch.kernels.lstm_scan``;
:func:`recurrent_scan_plain` and :func:`recurrent_scan_bwd_plain` on the
CPU. Its train-mode dropout draws ONE (D, B, 1, F) mask straight from the
key (four with ``per_gate``), not one per direction from ``fold_in``
(``mgr_tpu/ops/lstm.py:84-125``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from mgr_tpu_torch.core import prng, tracing
from mgr_tpu_torch.kernels import bilstm_tm as _kernel
from mgr_tpu_torch.kernels import lstm_scan as _scan
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.parallel import collectives
from mgr_tpu_torch.parallel import sharding

Params = Dict[str, torch.Tensor]


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


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` with an f32 result, and the backward JAX gives a dot with
    ``preferred_element_type=float32``: the f32 cotangent times the other
    operand (as f32), rounded to each operand's dtype. An explicit
    backward, because ``torch.mm(..., out_dtype=)`` has no autograd rule
    that can be relied on."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w.float().t()).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).float().t() @ g2).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 sums and an f32 result, whatever the operands'
    dtype (JAX's ``preferred_element_type=float32``); w is 2-D. A library
    GEMM: cuBLAS with an f32 output on the card, an f32 product of the
    (already rounded) operands on the CPU; differentiable in both."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulF32.apply(x, w)
    return _mm_f32(x, w)


def _projection_f32(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gate_scale: Optional[torch.Tensor],
) -> torch.Tensor:
    """(..., F) x (F, 4, H) + (4, H) -> (..., 4H) in f32: the operands as
    given, f32 sums, the bias added in f32."""
    F, _, H = w.shape
    if gate_scale is None:
        xp = _mm_f32(x, w.reshape(F, 4 * H))
    else:
        xp = torch.cat([_mm_f32(x * gate_scale[g], w[:, g, :]) for g in range(4)], dim=-1)
    return xp + b.reshape(4 * H)


class _Projection(torch.autograd.Function):
    """:func:`project` under autograd: the GEMM (or the four per-gate
    GEMMs), the f32 bias add and the rounding to ``out_dtype`` as one
    node, so its backward receives the cotangent in ``out_dtype``.

    The backward multiplies in the cotangent's dtype where x and w hold
    it too (a bf16 cotangent of bf16 operands: bf16 tensor cores on the
    card) and in f32 otherwise, always with f32 sums; the products are
    exact either way, so this is the backward of a dot with
    ``preferred_element_type=float32``. dx and dW are rounded once to
    their operand's dtype; db is the f32 sum of the cotangent. With
    ``gate_scale`` each gate's dx is scaled by its mask and the four are
    summed in dx's dtype, gate 3 first, as autograd sums them."""

    @staticmethod
    def forward(ctx, x, w, b, gate_scale, out_dtype):
        ctx.save_for_backward(x, w, gate_scale)
        return _projection_f32(x, w, b, gate_scale).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, gate_scale = ctx.saved_tensors
        F, _, H = w.shape
        cd = g.dtype if x.dtype == w.dtype == g.dtype else torch.float32
        g2, wc = g.reshape(-1, 4 * H).to(cd), w.to(cd)
        dx = dw = db = None
        if gate_scale is None:
            if ctx.needs_input_grad[0]:
                dx = _mm_f32(g2, wc.reshape(F, 4 * H).t()).reshape(x.shape).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _mm_f32(x.reshape(-1, F).to(cd).t(), g2).reshape(F, 4, H).to(w.dtype)
        else:
            gs = [g2[:, k * H:(k + 1) * H] for k in range(4)]
            if ctx.needs_input_grad[0]:
                parts = [_mm_f32(gs[k], wc[:, k, :].t()).reshape(x.shape).to(x.dtype)
                         * gate_scale[k] for k in range(4)]
                dx = parts[3] + parts[2] + parts[1] + parts[0]
            if ctx.needs_input_grad[1]:
                dw = torch.stack([_mm_f32((x * gate_scale[k]).reshape(-1, F).to(cd).t(), gs[k])
                                  for k in range(4)], dim=1).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.sum(0, dtype=torch.float32).reshape(4, H)
        return dx, dw, db, None, None


def project(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
    gate_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The input projection of every caller: x (..., F) and w (F, 4, H)
    in the compute dtype, b (4, H) -> (..., 4H) in ``out_dtype``, f32
    sums, the bias added in f32 first. ``gate_scale`` (4, ...), in the
    compute dtype, is per-gate input dropout: gate g sees
    ``x * gate_scale[g]`` (rounded in the compute dtype), as the JAX
    einsum ``gtbf,fgh->tbgh`` does. Differentiable through
    :class:`_Projection` whenever autograd records."""
    if _records_grad(x, w, b):
        return _Projection.apply(x, w, b, gate_scale, out_dtype)
    return _projection_f32(x, w, b, gate_scale).to(out_dtype)


def input_projection(
    x_tm: torch.Tensor, W: torch.Tensor, b: torch.Tensor, compute_dtype,
    gate_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One direction's projection: (T, B, F) x (F, 4, H) + (4, H) ->
    (T, B, 4, H) in the compute dtype, bias added in f32 first
    (:func:`project`; ``gate_scale`` (4, B, F))."""
    H = W.shape[-1]
    with tracing.annotate("mgr.lstm.projection"):
        xp = project(x_tm.to(compute_dtype), W.to(compute_dtype), b, compute_dtype,
                     gate_scale)
        return xp.reshape(*x_tm.shape[:-1], 4, H)


def dropout_scale(
    rng: prng.Key, keep: float, shape: Tuple[int, ...], dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    """``bernoulli(rng, keep, shape).astype(dtype) / keep`` in ``dtype``,
    as JAX divides by the scalar converted to the array's dtype (in bf16
    with keep 0.6: 1.6640625, not 1/0.6)."""
    mask = prng.bernoulli(rng, keep, shape, device)
    return mask.to(dtype) / torch.tensor(keep, dtype=dtype, device=device)


def _cell(z: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the cell: f32 pre-activations z (..., 4H) and the f32
    carry c (..., H) -> the new (h, c), f32."""
    H = c.shape[-1]
    s = hard_sigmoid(z)  # the i, f and o gates in one pass (g's block unused)
    g = torch.tanh(z[..., 2 * H:3 * H])
    c = s[..., 1 * H:2 * H] * c + s[..., 0 * H:1 * H] * g
    return s[..., 3 * H:4 * H] * torch.tanh(c), c


def lstm_scan_tm_plain(
    xp: torch.Tensor, U1: torch.Tensor, *, reverse: bool,
    store_c: bool = False, out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """Plain single-direction recurrence: the reference for kernel K5a
    (``_tm1_fwd_kernel``, ``pallas_kernels.py:1086-1119``).

    xp: (T, B, 4, H) projections in original time order, in the compute
    dtype; U1: (H, 4, H). ``reverse`` walks t = T-1 -> 0. Any T: the TPU
    kernel pads T at the end, and a reverse scan walks that padding first
    (``:1328-1335``); its zero projections keep the zero state, so
    skipping them is the same function. Returns (hs,) or, with
    ``store_c``, (hs, cs), (T, B, H) in ``out_dtype`` at original
    positions, each value rounded through the compute dtype (the stored
    streams)."""
    T, B, _, H = xp.shape
    cd = xp.dtype
    Uc = U1.to(cd).reshape(H, 4 * H)
    xf = xp.float().reshape(T, B, 4 * H)
    hs = torch.empty((T, B, H), dtype=cd, device=xp.device)
    cs = torch.empty_like(hs) if store_c else None
    h = torch.zeros((B, H), dtype=torch.float32, device=xp.device)
    c = torch.zeros_like(h)
    for s in range(T):
        t = T - 1 - s if reverse else s
        z = xf[t] + matmul_f32(h.to(cd), Uc)
        h, c = _cell(z, c)
        hs[t] = h.to(cd)
        if store_c:
            cs[t] = c.to(cd)
    return tuple(x.to(out_dtype) for x in ((hs, cs) if store_c else (hs,)))


def bilstm_scan_tm_plain(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    *, store_c: bool = False, out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """Plain recurrence: the reference for kernel K1.

    xp0, xp1: (T, B, 4, H) projections in original time order, in the
    compute dtype; U: (2, H, 4, H). Direction 1 walks t = T-1 -> 0.
    Returns hs0, hs1 (T, B, H) in ``out_dtype``, each value rounded
    through the compute dtype (the stored h stream), and with ``store_c``
    also the c streams, rounded the same way: :func:`lstm_scan_tm_plain`
    for each direction."""
    a = lstm_scan_tm_plain(xp0, U[0], reverse=False, store_c=store_c, out_dtype=out_dtype)
    b = lstm_scan_tm_plain(xp1, U[1], reverse=True, store_c=store_c, out_dtype=out_dtype)
    return (a[0], b[0]) + ((a[1], b[1]) if store_c else ())


def hard_sigmoid_grad(z: torch.Tensor) -> torch.Tensor:
    """The hard sigmoid's slope as the Pallas adjoint takes it: 0.2 on the
    OPEN interval (-2.5, 2.5), 0 at and beyond the ends
    (``pallas_kernels.py:876-877``). Autograd of ``torch.clamp`` passes
    the gradient at the closed ends, a different function."""
    return torch.where((z > -2.5) & (z < 2.5), 0.2, 0.0).to(z.dtype)


def lstm_scan_tm_bwd_plain(
    xp: torch.Tensor, U1: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: torch.Tensor, *, reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain adjoint of the single-direction recurrence: the reference for
    kernel K5b (``_tm1_bwd_kernel``, ``pallas_kernels.py:1151-1227``),
    written out rather than taken by autograd of the plain forward.

    xp (T, B, 4, H) and U1 (H, 4, H) as the forward took them; hs, cs
    (T, B, H) the STORED streams (``tanh(c_t)``, ``c_prev`` and ``h_prev``
    are read from them, not from f32 carries); dhs (T, B, H) the h
    stream's cotangent. A forward scan's adjoint walks t = T-1 -> 0 with
    its pre-state at t-1; a reverse scan's walks 0 -> T-1 with its
    pre-state at t+1; zero past either end (no padding: see
    :func:`lstm_scan_tm_plain`). dh and dc carry in f32; dz is rounded to
    the compute dtype before ``dh_prev = dz . U1^T``. Returns dz (T, B, 4,
    H) in the compute dtype (dxp = dz) and dU (H, 4, H) f32."""
    dz = _lstm_dz(xp, U1, hs, cs, dhs, reverse=reverse)
    return dz, lstm_weight_grad(hs, dz, reverse=reverse)


def _lstm_dz(
    xp: torch.Tensor, U1: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: torch.Tensor, *, reverse: bool,
) -> torch.Tensor:
    """dz (T, B, 4, H) of :func:`lstm_scan_tm_bwd_plain`."""
    T, B, _, H = xp.shape
    cd = xp.dtype
    Uc = U1.to(cd).reshape(H, 4 * H)
    UcT = Uc.t()
    # Whole-stream casts and gate passes once, outside the walk: each
    # element's value is the one a per-step cast or per-gate call gives.
    xf, hc, cf, dhf = xp.float().reshape(T, B, 4 * H), hs.to(cd), cs.float(), dhs.float()
    dz = torch.empty((T, B, 4 * H), dtype=cd, device=xp.device)
    dh_c = torch.zeros((B, H), dtype=torch.float32, device=xp.device)
    dc_c = torch.zeros_like(dh_c)
    zero = torch.zeros((B, H), dtype=cd, device=xp.device)
    for s in range(T):
        t = s if reverse else T - 1 - s
        t_pre = t + 1 if reverse else t - 1
        has_pre = 0 <= t_pre < T
        h_pre = hc[t_pre] if has_pre else zero
        c_pre = cf[t_pre] if has_pre else zero.float()
        z = xf[t] + matmul_f32(h_pre, Uc)
        sig, slope = hard_sigmoid(z), hard_sigmoid_grad(z)
        i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 3 * H:]
        g_ = torch.tanh(z[:, 2 * H:3 * H])
        tanh_c = torch.tanh(cf[t])
        dh = dhf[t] + dh_c
        do = dh * tanh_c
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dz_t = torch.cat([
            (dc * g_) * slope[:, :H],
            (dc * c_pre) * slope[:, H:2 * H],
            (dc * i) * (1.0 - g_ * g_),
            do * slope[:, 3 * H:],
        ], dim=1).to(cd)
        dz[t] = dz_t
        dh_c = matmul_f32(dz_t, UcT)
        dc_c = dc * f
    return dz.reshape(T, B, 4, H)


def bilstm_scan_tm_bwd_plain(
    xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
    hs0: torch.Tensor, hs1: torch.Tensor, cs0: torch.Tensor, cs1: torch.Tensor,
    dhs0: torch.Tensor, dhs1: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain adjoint of the recurrence: the reference for kernel K2
    (``_tm_bwd_kernel``, ``pallas_kernels.py:876-911``, and
    ``_tm_core_bwd`` :1013-1028): :func:`lstm_scan_tm_bwd_plain` for
    direction 0 (forward scan) and direction 1 (reverse scan). Returns dz0,
    dz1 (T, B, 4, H) in the compute dtype (dxp = dz) and dU (2, H, 4, H)
    f32."""
    dz0, dU0 = lstm_scan_tm_bwd_plain(xp0, U[0], hs0, cs0, dhs0, reverse=False)
    dz1, dU1 = lstm_scan_tm_bwd_plain(xp1, U[1], hs1, cs1, dhs1, reverse=True)
    return dz0, dz1, torch.stack([dU0, dU1])


def lstm_weight_grad(hs: torch.Tensor, dz: torch.Tensor, *, reverse: bool) -> torch.Tensor:
    """``dU = sum_t h_prev[t]^T dz[t]`` (H, 4, H) f32, one GEMM outside the
    kernel (``_tm1_core_bwd`` :1286-1294): a forward scan's pre-state
    stream is hs shifted back (zero at t=0), a reverse scan's is hs
    shifted forward (zero at T-1). Operands in the dz dtype, f32 sums.
    dz (T, B, 4, n) may hold a block of n of the H units: dU is then
    (H, 4, n)."""
    T, B, H = hs.shape
    zero = torch.zeros_like(hs[:1])
    hp = torch.cat([hs[1:], zero], dim=0) if reverse else torch.cat([zero, hs[:-1]], dim=0)
    dz2 = dz.reshape(T * B, -1)
    return _mm_f32(hp.to(dz2.dtype).reshape(T * B, H).t(), dz2).reshape(H, 4, -1)


def recurrent_weight_grad(
    hs0: torch.Tensor, hs1: torch.Tensor, dz0: torch.Tensor, dz1: torch.Tensor,
) -> torch.Tensor:
    """``dU`` (2, H, 4, H) f32 of both directions (``_tm_core_bwd``
    :1019-1027): :func:`lstm_weight_grad` of direction 0 (forward scan)
    and direction 1 (reverse scan)."""
    return torch.stack([lstm_weight_grad(hs0, dz0, reverse=False),
                        lstm_weight_grad(hs1, dz1, reverse=True)])


def _project(
    W: torch.Tensor, b: torch.Tensor, x_tm: torch.Tensor, d: int, *,
    rng: Optional[prng.Key], dropout: float, per_gate: bool, train: bool,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Direction d's (T, B, 4, H) projection with its weights ``W`` (F, 4,
    H) and ``b`` (4, H), in the compute dtype. In train mode with
    ``dropout`` > 0 its input is scaled by
    ``dropout_scale(fold_in(rng, d), 1 - dropout, ...)``, one (B, F) mask
    (or (4, B, F) with ``per_gate``), drawn at the global batch on the
    GSPMD route (``dispatch.draw_local``)."""
    _, B, F = x_tm.shape
    xc = x_tm.to(compute_dtype)
    if not (train and dropout > 0.0):
        return input_projection(xc, W, b, compute_dtype)
    shape = (4, B, F) if per_gate else (B, F)
    key = prng.fold_in(rng, d)
    scale = dispatch.draw_local(
        lambda s: dropout_scale(key, 1.0 - dropout, s, compute_dtype, x_tm.device),
        shape, batch_axis=len(shape) - 2)
    if per_gate:
        return input_projection(xc, W, b, compute_dtype, gate_scale=scale)
    return input_projection(xc * scale, W, b, compute_dtype)


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bilstm_layer_tm(
    params: Params,
    x_tm: torch.Tensor,
    *,
    rng: Optional[prng.Key] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Time-major bidirectional LSTM: (T, B, F) -> (T, B, 2H) in the
    compute dtype (forward half, then backward half).

    In train mode with ``dropout`` > 0, direction d scales its input by
    ``dropout_scale(fold_in(rng, d), 1 - dropout, ...)``, one (B, F) mask
    (or (4, B, F) with ``per_gate``) applied before the projection. The
    recurrence is differentiable (:class:`BiLSTMTm`) whenever autograd
    records. Under a direction-shard context the layer is
    :func:`bilstm_layer_tm_dirsharded` (``mgr_tpu/ops/lstm.py:423-437``),
    under an H-shard context :func:`bilstm_layer_tm_hsharded`."""
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    kw = dict(rng=rng, dropout=dropout, per_gate=per_gate, train=train,
              compute_dtype=compute_dtype)
    shard = dispatch.direction_shard_context()
    if shard is not None:
        return bilstm_layer_tm_dirsharded(params, x_tm, shard=shard, **kw)
    h_shard = dispatch.h_shard_context()
    if h_shard is not None:
        return bilstm_layer_tm_hsharded(params, x_tm, shard=h_shard, **kw)
    W, U, b = params["W"], params["U"], params["b"]
    xp0 = _project(W[0], b[0], x_tm, 0, **kw)
    xp1 = _project(W[1], b[1], x_tm, 1, **kw)
    return _bilstm_recurrence(xp0, xp1, U, compute_dtype)


def _bilstm_recurrence(xp0: torch.Tensor, xp1: torch.Tensor, U: torch.Tensor,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """Both directions' recurrence through K1 (K2 in the backward, whenever
    autograd records): (T, B, 2H) in the compute dtype."""
    if _records_grad(xp0, xp1, U):
        hs0, hs1 = _kernel.BiLSTMTm.apply(xp0, xp1, U)
    else:
        hs0, hs1 = _kernel.bilstm_tm(xp0, xp1, U)
    return torch.cat([hs0, hs1], dim=-1).to(compute_dtype)


def bilstm_layer_tm_dirsharded(
    params: Params,
    x_tm: torch.Tensor,
    *,
    shard: dispatch.DirectionShard,
    rng: Optional[prng.Key] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Direction-sharded BLSTM for tensor parallelism
    (``mgr_tpu/ops/lstm.py:272-371``): (T, B, F) -> (T, B, 2H). This rank
    computes direction ``shard.direction`` only: its projection with
    ``W[d]``, ``b[d]`` and dropout key ``fold_in(rng, d)``, exactly as
    :func:`bilstm_layer_tm`, its single-direction recurrence (K5a/K5b,
    :class:`LSTMTm`, reverse for d = 1), then the two h streams are
    exchanged over ``shard.group`` in the compute dtype
    (``collectives.gather_directions``). Parameters stay replicated; the
    gradient of ``W``, ``U``, ``b`` lands in slot d only."""
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    d = shard.direction
    xp = _project(params["W"][d], params["b"][d], x_tm, d, rng=rng, dropout=dropout,
                  per_gate=per_gate, train=train, compute_dtype=compute_dtype)
    U1 = params["U"][d]
    if _records_grad(xp, U1):
        hs = _kernel.LSTMTm.apply(xp, U1, d == 1)
    else:
        hs = _kernel.lstm_tm_streams(xp, U1, reverse=d == 1)[0]
    both = collectives.gather_directions(hs.to(compute_dtype), shard.group, d)
    return torch.cat([both[0], both[1]], dim=-1)


def _hsharded_steps(
    xp: torch.Tensor, U: torch.Tensor, group, index: int, *, store: bool,
) -> Tuple[torch.Tensor, ...]:
    """The forward of :class:`_HShardedScan`: both directions in one walk
    over s = 0 .. T-1, direction 0 at t = s and direction 1 at t = T-1-s.
    Each step computes this rank's block of the pre-activations, ``z =
    xp[t] + bf16(h_{t-1}) @ U_block`` with f32 sums, and of the cell (c in
    f32), then exchanges the h blocks, rounded to the compute dtype, over
    the model group (one all-reduce). Returns hs (T, 2, B, H) in the
    compute dtype at original time positions, and with ``store`` the f32
    residuals z (T, 2, B, 4n) and c (T, 2, B, n) by walk step."""
    T, _, B, _, n = xp.shape
    H = U.shape[1]
    cd = xp.dtype
    Uc = U.to(cd).reshape(2, H, 4 * n)
    h = torch.zeros((2, B, H), dtype=cd, device=xp.device)
    c = torch.zeros((2, B, n), dtype=torch.float32, device=xp.device)
    hs = torch.empty((T, 2, B, H), dtype=cd, device=xp.device)
    zs = torch.empty((T, 2, B, 4 * n), dtype=torch.float32, device=xp.device) if store else None
    cs = torch.empty((T, 2, B, n), dtype=torch.float32, device=xp.device) if store else None
    for s in range(T):
        r = T - 1 - s
        z = torch.stack([xp[s, 0], xp[r, 1]]).float().reshape(2, B, 4 * n) + torch.stack(
            [_mm_f32(h[d], Uc[d]) for d in range(2)])
        h_blk, c = _cell(z, c)
        h = collectives.gather_blocks(h_blk.to(cd), group, index, -1)
        hs[s, 0], hs[r, 1] = h[0], h[1]
        if store:
            zs[s], cs[s] = z, c
    return (hs, zs, cs) if store else (hs,)


class _HShardedScan(torch.autograd.Function):
    """``(xp, U) -> hs``: the two-direction recurrence with the hidden units
    split over the model group (``lax.scan`` over a carry whose H axis XLA
    shards, ``mgr_tpu/ops/lstm.py:146-183``). xp (T, 2, B, 4, n): this
    rank's block of n units of both directions' projections, in the compute
    dtype, over all T; U (2, H, 4, n): the block's columns of U. hs (T, 2,
    B, H): every unit, in the compute dtype, on every rank of the group.

    The backward is the autodiff of that scan on its f32 residuals (z and
    c as the forward computed them), walking the steps back: the cotangent
    of step s's whole h (the output's and the partial ``dz_{s+1} @
    U_block^T`` of step s+1) is summed over the group by one all-reduce
    and this rank's block taken (the exchange's transpose); dz on the
    block is rounded to the compute dtype where it meets a compute-dtype
    operand (dxp = dz, as the projection's backward takes it, and the next
    partial); dU_block is ``sum_t h_prev^T dz`` in one GEMM a direction,
    rounded through the compute dtype, as :class:`BiLSTMTm` rounds dU.
    The hard sigmoid's slope is 0.2 on the open interval, as
    :func:`hard_sigmoid_grad` takes it."""

    @staticmethod
    def forward(ctx, xp, U, group, index):
        hs, zs, cs = _hsharded_steps(xp, U, group, index, store=True)
        ctx.group, ctx.index = group, index
        ctx.save_for_backward(U, hs, zs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        U, hs, zs, cs = ctx.saved_tensors
        T, _, B, H = hs.shape
        n = cs.shape[-1]
        cd = hs.dtype
        UcT = U.to(cd).reshape(2, H, 4 * n).transpose(1, 2).contiguous()
        dz_time = torch.empty((T, 2, B, 4 * n), dtype=cd, device=hs.device)
        part = torch.zeros((2, B, H), dtype=torch.float32, device=hs.device)
        dc = torch.zeros((2, B, n), dtype=torch.float32, device=hs.device)
        for s in reversed(range(T)):
            r = T - 1 - s
            dh = collectives.psum_block(torch.stack([dhs[s, 0], dhs[r, 1]]).float() + part,
                                        ctx.group, ctx.index, -1)
            z = zs[s]
            z_i, z_f, z_g, z_o = (z[..., g * n:(g + 1) * n] for g in range(4))
            i, f, o = hard_sigmoid(z_i), hard_sigmoid(z_f), hard_sigmoid(z_o)
            g_ = torch.tanh(z_g)
            c_pre = cs[s - 1] if s > 0 else torch.zeros_like(dc)
            tanh_c = torch.tanh(cs[s])
            dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
            dz = torch.cat([
                (dc * g_) * hard_sigmoid_grad(z_i),
                (dc * c_pre) * hard_sigmoid_grad(z_f),
                (dc * i) * (1.0 - g_ * g_),
                (dh * tanh_c) * hard_sigmoid_grad(z_o),
            ], dim=-1).to(cd)
            dc = dc * f
            dz_time[s, 0], dz_time[r, 1] = dz[0], dz[1]
            part = torch.stack([_mm_f32(dz[d], UcT[d]) for d in range(2)])
        dz_time = dz_time.reshape(T, 2, B, 4, n)
        dU = torch.stack([lstm_weight_grad(hs[:, d], dz_time[:, d], reverse=d == 1)
                          for d in range(2)])
        return dz_time, dU.to(cd).to(U.dtype), None, None


def bilstm_layer_tm_hsharded(
    params: Params,
    x_tm: torch.Tensor,
    *,
    shard: dispatch.HShard,
    rng: Optional[prng.Key] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """This rank's part of a BLSTM layer on the GSPMD route: ``x_tm`` is
    this rank's time slice (T / time, B, F) of the layer's input, and the
    output (T, B, 2H) is the whole layer's, the same on every rank of the
    model and time axes.

    Where the model axis divides H (``sharding.h_sharded``), this rank
    projects its slice with its block of n = H / model units of ``W[d]``
    and ``b[d]`` (the gate-blocked (..., 4, H) layout makes the block a
    slice of the last axis), gathers the slices over the time axis
    (``collectives.gather_time``) and runs :class:`_HShardedScan`: one
    exchange of h over the model axis a step. Elsewhere (a model axis of
    1, or one that does not divide H, where JAX replicates the leaves) it
    projects its slice with all of ``W[d]``, gathers, and runs the whole
    recurrence through K1/K2 (:class:`BiLSTMTm`), as does every rank of
    the model axis. Dropout as :func:`bilstm_layer_tm`, the masks drawn at
    the global batch (``dispatch.draw_local``). The gradients are this
    rank's part (``train.step``'s GSPMD route combines them)."""
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    W, U, b = params["W"], params["U"], params["b"]
    blocked = sharding.h_sharded(U.shape[1], shard.config)
    if blocked:
        n = U.shape[1] // shard.model
        cols = slice(shard.model_index * n, (shard.model_index + 1) * n)
        W, U, b = W[..., cols], U[..., cols], b[..., cols]
    kw = dict(rng=rng, dropout=dropout, per_gate=per_gate, train=train,
              compute_dtype=compute_dtype)
    xp = torch.stack([_project(W[d], b[d], x_tm, d, **kw) for d in range(2)], dim=1)
    if shard.time > 1:
        xp = collectives.gather_time(xp, shard.time_group, shard.time_index)
    if not blocked:
        return _bilstm_recurrence(xp[:, 0], xp[:, 1], U, compute_dtype)
    if _records_grad(xp, U):
        hs = _HShardedScan.apply(xp, U, shard.model_group, shard.model_index)
    else:
        (hs,) = _hsharded_steps(xp, U, shard.model_group, shard.model_index, store=False)
    return torch.cat([hs[:, 0], hs[:, 1]], dim=-1)


# ---------------------------------------------------------------------------
# Batch-major layer API (``mgr_tpu/ops/lstm.py:84-269, 374-390``).
# ---------------------------------------------------------------------------

def _scan_steps(
    xp: torch.Tensor, Uc: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    *, store_c: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Forward scans of D directions: xp (D, B, T, 4, H) added in f32,
    Uc (D, H, 4H) and the h operand in Uc's dtype (the compute dtype), f32
    carries h, c (D, B, H). Returns the stored streams [hs] or [hs, cs]
    (D, B, T, H) in the compute dtype and the last carries."""
    D, B, T, _, H = xp.shape
    cd = Uc.dtype
    hs, cs = [], []
    for t in range(T):
        z = xp[:, :, t].float().reshape(D, B, 4 * H) + torch.stack(
            [matmul_f32(h[d].to(cd), Uc[d]) for d in range(D)])
        h, c = _cell(z, c)
        hs.append(h.to(cd))
        if store_c:
            cs.append(c.to(cd))
    return [torch.stack(s, dim=2) for s in ((hs, cs) if store_c else (hs,))], h, c


def recurrent_scan_plain(
    xp: torch.Tensor, U: torch.Tensor, *, store_c: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """Plain recurrence of D directions that all scan forward: the
    reference for kernel K6a (``_fwd_kernel``, ``pallas_kernels.py:67-115``)
    and, in f32, JAX's XLA ``_recurrent_scan`` (``mgr_tpu/ops/lstm.py:
    159-183``).

    xp: (D, B, T, 4, H) projections in the compute dtype (direction 1's
    already from the flipped input); U: (D, H, 4, H). Returns (hs,) or,
    with ``store_c``, (hs, cs), (D, B, T, H) in ``out_dtype``, each value
    rounded through the compute dtype (the stored streams). Any T: the TPU
    kernel pads T at the end, after every real step of a forward scan."""
    D, B, T, _, H = xp.shape
    zero = torch.zeros((D, B, H), dtype=torch.float32, device=xp.device)
    streams, _, _ = _scan_steps(xp, U.to(xp.dtype).reshape(D, H, 4 * H), zero, zero,
                                store_c=store_c)
    return tuple(s.to(out_dtype) for s in streams)


def recurrent_scan_bwd_plain(
    xp: torch.Tensor, U: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: torch.Tensor,
) -> torch.Tensor:
    """Plain adjoint of :func:`recurrent_scan_plain`: the reference for
    kernel K6b (``_bwd_kernel``, ``pallas_kernels.py:164-256``), written
    out as :func:`lstm_scan_tm_bwd_plain` is, for each direction's forward
    scan. xp (D, B, T, 4, H) and U (D, H, 4, H) as the forward took them;
    hs, cs (D, B, T, H) the stored streams; dhs (D, B, T, H) the h
    streams' cotangent. Returns dz (D, B, T, 4, H) in the compute dtype
    (dxp = dz); dU is :func:`scan_weight_grad`."""
    def tm(a: torch.Tensor, d: int) -> torch.Tensor:  # direction d, time-major
        return a[d].transpose(0, 1)

    return torch.stack([
        _lstm_dz(tm(xp, d), U[d], tm(hs, d), tm(cs, d), tm(dhs, d),
                 reverse=False).transpose(0, 1)
        for d in range(xp.shape[0])
    ])


def scan_weight_grad(hs: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """``dU = sum_t h_prev[t]^T dz[t]`` (D, H, 4, H) f32 of forward scans,
    one GEMM per direction outside the kernel (``_scan_core_bwd``,
    ``pallas_kernels.py:328-334``): h_prev is hs one step later in time,
    zero at t=0. hs (D, B, T, H), dz (D, B, T, 4, H); operands in dz's
    dtype, f32 sums."""
    D, B, T, H = hs.shape
    hp = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2).to(dz.dtype)
    return torch.stack([
        _mm_f32(hp[d].reshape(B * T, H).t(), dz[d].reshape(B * T, 4 * H))
        for d in range(D)
    ]).reshape(D, H, 4, H)


def input_projection_bm(
    x2: torch.Tensor, W: torch.Tensor, b: torch.Tensor, *,
    rng: Optional[prng.Key], dropout: float, per_gate: bool, train: bool,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """``_input_projection`` (``mgr_tpu/ops/lstm.py:84-125``): x2 (D, B, T,
    F), W (D, F, 4, H), b (D, 4, H) -> (D, B, T, 4, H), operands in the
    compute dtype, f32 sums, the bias added in f32.

    In train mode with ``dropout`` > 0 the input is scaled by ONE
    ``dropout_scale(rng, 1 - dropout, (D, B, 1, F))`` drawn straight from
    ``rng`` (no per-direction ``fold_in``), or with ``per_gate`` by
    (4, D, B, 1, F), gate g seeing ``x * scale[g]``. The per-gate
    projection is returned in f32 (``:113``); every other one is rounded
    to the compute dtype (``:125``)."""
    D, B, T, F = x2.shape
    H = W.shape[-1]
    xc, Wc = x2.to(compute_dtype), W.to(compute_dtype)
    dropping = train and dropout > 0.0
    if dropping:
        shape = (4, D, B, 1, F) if per_gate else (D, B, 1, F)
        scale = dropout_scale(rng, 1.0 - dropout, shape, compute_dtype, x2.device)
        if not per_gate:
            xc = xc * scale
    gated = dropping and per_gate
    out_dtype = torch.float32 if gated else compute_dtype
    xp = torch.stack([project(xc[d], Wc[d], b[d], out_dtype, scale[:, d] if gated else None)
                      for d in range(D)])
    return xp.reshape(D, B, T, 4, H)


def recurrent_scan(
    xp: torch.Tensor, U: torch.Tensor, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """``_recurrent_scan`` (``mgr_tpu/ops/lstm.py:146-183``) with the
    kernel backend: xp (D, B, T, 4, H) projections, U (D, H, 4, H) -> h
    streams (D, B, T, H) in the compute dtype, every direction scanning
    forward. K6a on a CUDA device, differentiable through K6b whenever
    autograd records (:class:`~mgr_tpu_torch.kernels.lstm_scan.LSTMScan`);
    the plain versions on the CPU. xp is rounded to the compute dtype
    first (an f32 per-gate projection included), as the kernel rounds its
    operands (``pallas_kernels.py:374``)."""
    xp = xp.to(compute_dtype)
    if _records_grad(xp, U):
        hs = _scan.LSTMScan.apply(xp, U)
    else:
        hs = _scan.lstm_scan_streams(xp, U)[0]
    return hs.to(compute_dtype)


def recurrent_scan_remat(
    xp: torch.Tensor, U: torch.Tensor, compute_dtype: torch.dtype, chunk: int = 64,
) -> torch.Tensor:
    """``_recurrent_scan_remat`` (``mgr_tpu/ops/lstm.py:186-229``): the
    plain recurrence over chunks of ``chunk`` steps, each under
    ``torch.utils.checkpoint``, so the backward keeps the carries between
    chunks and recomputes one chunk's activations at a time. xp (D, B, T,
    4, H) is added in f32 whatever its dtype; U and the h operand are in
    the compute dtype. Returns hs (D, B, T, H) in the compute dtype."""
    D, B, T, _, H = xp.shape
    Uc = U.to(compute_dtype).reshape(D, H, 4 * H)
    h = c = torch.zeros((D, B, H), dtype=torch.float32, device=xp.device)
    out = []
    for t0 in range(0, T, chunk):
        (hs,), h, c = checkpoint(_scan_steps, xp[:, :, t0:t0 + chunk], Uc, h, c,
                                 use_reentrant=False)
        out.append(hs)
    return torch.cat(out, dim=2)


def bilstm_layer(
    params: Params,
    x: torch.Tensor,
    *,
    rng: Optional[prng.Key] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    """Batch-major bidirectional LSTM, merge_mode='concat' (``bilstm_layer``,
    ``mgr_tpu/ops/lstm.py:232-269``): (B, T, F) -> (B, T, 2H) in the
    compute dtype. Direction 1 projects the time-flipped input and its h
    stream is flipped back. ``remat`` takes :func:`recurrent_scan_remat`
    on the CPU; a CUDA tensor ignores it and runs K6, which already keeps
    only the bf16 h and c streams for the backward (as JAX ignores it on
    its Pallas backend)."""
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    x2 = torch.stack([x, torch.flip(x, dims=(1,))])
    xp = input_projection_bm(x2, params["W"], params["b"], rng=rng, dropout=dropout,
                             per_gate=per_gate, train=train, compute_dtype=compute_dtype)
    if remat and not xp.is_cuda:
        hs = recurrent_scan_remat(xp, params["U"], compute_dtype)
    else:
        hs = recurrent_scan(xp, params["U"], compute_dtype)
    return torch.cat([hs[0], torch.flip(hs[1], dims=(1,))], dim=-1)


def lstm_layer(
    params: Params,
    x: torch.Tensor,
    *,
    reverse: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Single-direction LSTM, no dropout (``lstm_layer``,
    ``mgr_tpu/ops/lstm.py:374-390``): params W (F, 4, H), U (H, 4, H),
    b (4, H); (B, T, F) -> (B, T, H) in the compute dtype. ``reverse``
    flips the input before the scan and the output after it."""
    xi = torch.flip(x, dims=(1,)) if reverse else x
    xp = input_projection_bm(xi[None], params["W"][None], params["b"][None], rng=None,
                             dropout=0.0, per_gate=False, train=False,
                             compute_dtype=compute_dtype)
    hs = recurrent_scan(xp, params["U"][None], compute_dtype)[0]
    return torch.flip(hs, dims=(1,)) if reverse else hs
