"""Batched best-path decoding.

Counterpart of ``mgr_tpu/ops/decoding.py``: per-frame argmax and
max-probability, drop frames below a confidence threshold (a vectorised
mask, not the reference's list mutation), collapse consecutive repeats,
and optionally drop the blank. Runs on whatever device the
probabilities are on; only the int argmax and the bool emit mask need to
reach the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def best_path_decode(
    probs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    threshold: float = 0.0,
    trim_frames: int = 0,
    collapse: bool = True,
    blank: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C) frame probabilities -> (best, emit), each (B, T').

    ``best`` is the per-frame argmax class (int32); ``emit[b, t]`` is True
    for frames that survive thresholding and repeat-collapse, so the
    decoded sequence is ``best[b, emit[b]]``. ``blank``, if given, is
    dropped from the output."""
    if trim_frames:
        probs = probs[:, trim_frames:, :]
    B, T, _ = probs.shape
    conf, best = torch.max(probs, dim=-1)
    best = best.to(torch.int32)
    frames = torch.arange(T, device=probs.device)

    valid = torch.ones((B, T), dtype=torch.bool, device=probs.device)
    if threshold > 0.0:
        valid &= conf >= threshold
    if input_lengths is not None:
        valid &= frames[None, :] < input_lengths.to(probs.device).reshape(B, 1)

    if collapse:
        # Most recent valid frame strictly before t: an exclusive
        # cumulative max over (t if valid else -1).
        idx = torch.where(valid, frames[None, :], -1)
        inclusive = torch.cummax(idx, dim=1).values
        prev_idx = torch.cat(
            [torch.full_like(inclusive[:, :1], -1), inclusive[:, :-1]], dim=1
        )
        prev_best = torch.gather(best, 1, prev_idx.clamp_min(0))
        emit = valid & ((prev_idx < 0) | (best != prev_best))
    else:
        emit = valid

    if blank is not None:
        emit &= best != blank
    return best, emit


def emitted_sequences(best: torch.Tensor, emit: torch.Tensor) -> List[List[int]]:
    """Host-side ragged extraction of the emitted token sequences."""
    best, emit = best.cpu().numpy(), emit.cpu().numpy()
    return [best[b][emit[b]].tolist() for b in range(best.shape[0])]
