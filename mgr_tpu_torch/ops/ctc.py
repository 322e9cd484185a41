"""CTC loss: log-space forward recursion and its exact adjoint.

Counterpart of ``mgr_tpu/ops/ctc.py``, with its conventions:

  * blank = K - 1 unless given;
  * labels padded with -1 (read as label 0, past the label length they
    never count);
  * a label length of 0 is scored as "emit only blanks";
  * the first ``trim_frames`` frames are dropped before the loss, and
    ``input_lengths`` already excludes them;
  * the phi/emit recursion uses ``-1e5`` as its log-epsilon (not
    ``-inf``), forbids the direct emit[n-1] -> emit[n] step where the two
    labels are equal, and freezes the carries for ``t >= input_length``.

The recursion is kernel K3 (``csrc/ctc_fwd.cu``) on a CUDA device and
:func:`ctc_alpha_loss_plain` on the CPU; its adjoint is kernel K4
(``csrc/ctc_bwd.cu``) and :func:`ctc_alpha_bwd_plain`, chosen by
``mgr_tpu_torch.kernels.ctc``, whose ``CTCAlphaLoss`` differentiates the
loss whenever autograd records. Log-softmax stays plain PyTorch.
``torch.nn.functional.ctc_loss`` appears only in the tests, as an oracle,
beside the JAX package's NumPy oracle :func:`ctc_loss_reference` (copied
at the end of this module).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from mgr_tpu_torch.kernels import ctc as _kernel

LOG_EPS = -1e5  # effectively -inf, as in the JAX package


def _lattice(log_probs_tm: torch.Tensor, labels: torch.Tensor, blank: int):
    """Emission scores of every label at every frame (T, B, N) (a label
    >= K scores 0, as the JAX one-hot packing does), the blank column
    (T, B), the labels read as classes (B, N) with their in-range mask,
    and the skip penalty (B, N): LOG_EPS at column 0 and where a label
    repeats the one before it."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    lp = log_probs_tm.to(torch.float32)
    lab = labels.to(torch.int64).clamp_min(0)
    in_range = lab < K
    idx = torch.where(in_range, lab, 0)
    lp_emit = torch.gather(lp, 2, idx[None].expand(T, B, N)) * in_range[None]
    lp_phi = lp[:, :, blank]
    same = lab[:, 1:] == lab[:, :-1]
    skip = torch.cat([
        torch.ones_like(lab[:, :1], dtype=torch.bool), same], dim=1)
    skip = torch.where(skip, LOG_EPS, 0.0).to(torch.float32)[:, :N]
    return lp_emit, lp_phi, idx, in_range, skip


def ctc_alpha_loss_plain(
    log_probs_tm: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int,
    *,
    store_alphas: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Plain phi/emit recursion over time: the reference for kernel K3.

    log_probs_tm (T, B, K); labels (B, N) -1 padded; lengths (B,).
    Returns the per-sequence negative log-likelihood (B,) f32
    (``mgr_tpu/ops/ctc.py:74-148``), and with ``store_alphas`` also the
    post-step alphas alpha_phi (T, B, N+1) and alpha_emit (T, B, N) f32,
    frozen for t >= input_length (``pallas_kernels.py:439-443``)."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    dev = log_probs_tm.device
    lp_emit, lp_phi, _, _, skip = _lattice(log_probs_tm, labels, blank)
    in_len = input_lengths.to(torch.int64).reshape(B)
    lab_len = label_lengths.to(torch.int64).reshape(B).clamp(0, N)
    neg_col = torch.full((B, 1), LOG_EPS, dtype=torch.float32, device=dev)

    phi = torch.full((B, N + 1), LOG_EPS, dtype=torch.float32, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPS, dtype=torch.float32, device=dev)
    if store_alphas:
        alpha_phi = torch.empty((T, B, N + 1), dtype=torch.float32, device=dev)
        alpha_emit = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    for t in range(T):
        prev_shift = torch.cat([neg_col, emit[:, :-1]], dim=1) + skip
        new_emit = torch.logaddexp(
            torch.logaddexp(emit, phi[:, :N]), prev_shift
        ) + lp_emit[t]
        emit_shift = torch.cat([neg_col, emit], dim=1)
        new_phi = torch.logaddexp(phi, emit_shift) + lp_phi[t][:, None]
        valid = (t < in_len)[:, None]
        phi = torch.where(valid, new_phi, phi)
        emit = torch.where(valid, new_emit, emit)
        if store_alphas:
            alpha_phi[t], alpha_emit[t] = phi, emit

    rows = torch.arange(B, device=dev)
    final_phi = phi[rows, lab_len]
    final_emit = torch.full_like(final_phi, LOG_EPS)  # N = 0: the all-blank path alone
    if N:
        final_emit = torch.where(
            lab_len > 0, emit[rows, (lab_len - 1).clamp_min(0)], final_emit)
    loss = -torch.logaddexp(final_phi, final_emit)
    return (loss, alpha_phi, alpha_emit) if store_alphas else loss


def ctc_alpha_bwd_plain(
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
    """Plain adjoint of the recursion: the reference for kernel K4
    (``_ctc_bwd_kernel``, ``pallas_kernels.py:491-572``, seeded as
    ``_ctc_alpha_loss_bwd`` :658-684 seeds it).

    From the post-step alphas of :func:`ctc_alpha_loss_plain` and the
    seeds g_phi (B,) at phi[L] and g_emit (B,) at emit[L-1] (ignored where
    L = 0), walks time in reverse: the weights ``exp(prev - y_pre)``, the
    left-shift adjoint of the forward's right shift, ``d lp_blank =
    sum_n dphi``, and zero on frames with t >= input_length. The emission
    adjoints are scattered onto their classes (adding where labels
    repeat). Returns d log_probs (T, B, K) f32."""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    dev = log_probs_tm.device
    lp_emit, lp_phi, idx, in_range, skip = _lattice(log_probs_tm, labels, blank)
    in_len = input_lengths.to(torch.int64).reshape(B)
    lab_len = label_lengths.to(torch.int64).reshape(B).clamp(0, N)
    rows = torch.arange(B, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    dp = torch.zeros((B, N + 1), **f32)
    dp[rows, lab_len] = g_phi.to(torch.float32)
    da = torch.zeros((B, N + 1), **f32)  # column N: no emission, stays 0
    da[rows, (lab_len - 1).clamp_min(0)] = torch.where(
        lab_len > 0, g_emit.to(torch.float32), 0.0)
    da = da[:, :N].contiguous()
    neg_col = torch.full((B, 1), LOG_EPS, **f32)
    zero_col = torch.zeros((B, 1), **f32)
    init_e = torch.full((B, N), LOG_EPS, **f32)
    init_p = torch.full((B, N + 1), LOG_EPS, **f32)
    init_p[:, 0] = 0.0

    dlp = torch.zeros((T, B, K), **f32)
    for t in reversed(range(T)):
        e_prev = alpha_emit[t - 1] if t > 0 else init_e
        p_prev = alpha_phi[t - 1] if t > 0 else init_p
        shift = torch.cat([neg_col, e_prev], dim=1)  # (B, N+1): emit[n-1]
        y_e = alpha_emit[t] - lp_emit[t]
        y_p = alpha_phi[t] - lp_phi[t][:, None]
        dsa = da * torch.exp(shift[:, :N] + skip - y_e)
        des = dp * torch.exp(shift - y_p)
        da_prev = da * torch.exp(e_prev - y_e) + torch.cat([dsa[:, 1:], zero_col], dim=1)
        da_prev = da_prev + des[:, 1:]
        dp_prev = torch.cat([da * torch.exp(p_prev[:, :N] - y_e), zero_col], dim=1)
        dp_prev = dp_prev + dp * torch.exp(p_prev - y_p)

        valid = (t < in_len)[:, None]
        dlp[t].scatter_add_(1, idx, torch.where(valid & in_range, da, 0.0))
        dlp[t, :, blank] += torch.where(valid[:, 0], dp.sum(dim=1), 0.0)
        da = torch.where(valid, da_prev, da)
        dp = torch.where(valid, dp_prev, dp)
    return dlp


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: Optional[int] = None,
    *,
    time_major: bool = False,
) -> torch.Tensor:
    """Per-sequence negative log-likelihood (B,).

    log_probs: (B, T, K) log-probabilities, or (T, B, K) with
    ``time_major``. Same contract as ``mgr_tpu.ops.ctc.ctc_loss``."""
    lp_tm = log_probs if time_major else log_probs.transpose(0, 1)
    if blank is None:
        blank = lp_tm.shape[-1] - 1
    if torch.is_grad_enabled() and lp_tm.requires_grad:
        return _kernel.CTCAlphaLoss.apply(
            lp_tm, labels, input_lengths, label_lengths, blank
        )
    return _kernel.ctc_alpha_loss(
        lp_tm, labels, input_lengths, label_lengths, blank
    )


def ctc_loss_from_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: Optional[int] = None,
    trim_frames: int = 0,
    time_major: bool = False,
) -> torch.Tensor:
    """CTC loss from unnormalised logits, after the reference's leading-
    frame trim. ``time_major`` takes (T, B, K) logits straight from the
    model's time-major path."""
    if trim_frames:
        logits = logits[trim_frames:] if time_major else \
            logits[:, trim_frames:, :]
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return ctc_loss(
        log_probs, labels, input_lengths, label_lengths, blank,
        time_major=time_major,
    )


# NumPy reference (tests only), copied from the JAX package
# (``mgr_tpu/ops/ctc.py:189, 238``): the classic (T, 2L+1) lattice forward
# pass, O(T * S) per sequence, independent of the formulation above, so the
# two cross-check each other.

def ctc_loss_reference(
    log_probs: np.ndarray,
    labels: np.ndarray,
    input_length: int,
    label_length: int,
    blank: Optional[int] = None,
) -> float:
    """Single-sequence CTC NLL via the extended-label lattice."""
    T, K = log_probs.shape
    if blank is None:
        blank = K - 1
    lab = [int(x) for x in labels[:label_length]]
    # Extended sequence: blank, l1, blank, l2, ..., lN, blank.
    ext = [blank]
    for l in lab:
        ext += [l, blank]
    S = len(ext)

    neg_inf = -np.inf
    alpha = np.full(S, neg_inf)
    alpha[0] = log_probs[0, ext[0]]
    if S > 1:
        alpha[1] = log_probs[0, ext[1]]

    def lse(*xs):
        xs = [x for x in xs if x != neg_inf]
        if not xs:
            return neg_inf
        m = max(xs)
        return m + np.log(sum(np.exp(x - m) for x in xs))

    for t in range(1, input_length):
        new = np.full(S, neg_inf)
        for s in range(S):
            cands = [alpha[s]]
            if s >= 1:
                cands.append(alpha[s - 1])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                cands.append(alpha[s - 2])
            new[s] = lse(*cands) + log_probs[t, ext[s]]
        alpha = new

    if S == 1:
        total = alpha[0]
    else:
        total = lse(alpha[S - 1], alpha[S - 2])
    return float(-total)


def ctc_loss_reference_batch(
    log_probs: np.ndarray,
    labels: np.ndarray,
    input_lengths: np.ndarray,
    label_lengths: np.ndarray,
    blank: Optional[int] = None,
) -> np.ndarray:
    return np.array(
        [
            ctc_loss_reference(
                log_probs[b], labels[b], int(input_lengths[b]),
                int(label_lengths[b]), blank,
            )
            for b in range(log_probs.shape[0])
        ]
    )
