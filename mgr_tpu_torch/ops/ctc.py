"""CTC loss: log-space forward recursion (eval path).

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
:func:`ctc_alpha_loss_plain` on the CPU, chosen by
``mgr_tpu_torch.kernels.ctc``. Log-softmax stays plain PyTorch.
``torch.nn.functional.ctc_loss`` appears only in the tests, as an oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from mgr_tpu_torch.kernels import ctc as _kernel

LOG_EPS = -1e5  # effectively -inf, as in the JAX package


def ctc_alpha_loss_plain(
    log_probs_tm: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int,
) -> torch.Tensor:
    """Plain phi/emit recursion over time: the reference for kernel K3.

    log_probs_tm (T, B, K); labels (B, N) -1 padded; lengths (B,).
    Returns the per-sequence negative log-likelihood (B,) f32.
    (``mgr_tpu/ops/ctc.py:74-148``.)"""
    T, B, K = log_probs_tm.shape
    N = labels.shape[1]
    dev = log_probs_tm.device
    lp = log_probs_tm.to(torch.float32)
    lab = labels.to(torch.int64).clamp_min(0)
    in_len = input_lengths.to(torch.int64).reshape(B)
    lab_len = label_lengths.to(torch.int64).reshape(B)

    # Emission scores of every label at every frame (a label >= K scores
    # 0, as the JAX one-hot packing does), and the blank column.
    in_range = lab < K
    idx = torch.where(in_range, lab, 0)[None].expand(T, B, N)
    lp_emit = torch.gather(lp, 2, idx) * in_range[None]  # (T, B, N)
    lp_phi = lp[:, :, blank]  # (T, B)

    same = lab[:, 1:] == lab[:, :-1]
    skip = torch.where(same, LOG_EPS, 0.0).to(torch.float32)  # (B, N-1)
    neg_col = torch.full((B, 1), LOG_EPS, dtype=torch.float32, device=dev)

    phi = torch.full((B, N + 1), LOG_EPS, dtype=torch.float32, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPS, dtype=torch.float32, device=dev)
    for t in range(T):
        prev_shift = torch.cat([neg_col, emit[:, :-1] + skip], dim=1)
        new_emit = torch.logaddexp(
            torch.logaddexp(emit, phi[:, :N]), prev_shift
        ) + lp_emit[t]
        emit_shift = torch.cat([neg_col, emit], dim=1)
        new_phi = torch.logaddexp(phi, emit_shift) + lp_phi[t][:, None]
        valid = (t < in_len)[:, None]
        phi = torch.where(valid, new_phi, phi)
        emit = torch.where(valid, new_emit, emit)

    rows = torch.arange(B, device=dev)
    final_phi = phi[rows, lab_len]
    final_emit = torch.where(
        lab_len > 0, emit[rows, (lab_len - 1).clamp_min(0)], LOG_EPS
    )
    return -torch.logaddexp(final_phi, final_emit)


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
