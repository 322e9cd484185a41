"""Eval, predict and decode steps: the serving half of
``mgr_tpu/train/step.py`` (``:323-404``).

JAX's steps take ``(params, ...)``; here the parameters live in the
module, so a step takes the batch alone. Inputs may be numpy arrays or
tensors; they are moved to the model's device. Every step runs under
``torch.inference_mode()``. The train step is not ported yet.

Batch contract (as in the JAX package): ``inputs`` (B, T, F),
``labels`` (B, N) int -1 padded, ``input_length`` (B,) valid frames
AFTER the CTC trim, ``label_length`` (B,).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mgr_tpu_torch.ops.ctc import ctc_loss_from_logits
from mgr_tpu_torch.ops.decoding import best_path_decode


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def make_eval_step(model: nn.Module) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Returns step(batch) -> mean CTC loss (no dropout or noise), on the
    time-major path: (T, B, C) logits go straight to the CTC kernel."""
    cfg = model.config
    dev = model_device(model)

    @torch.inference_mode()
    def step(batch: Dict[str, Any]) -> torch.Tensor:
        logits = model.apply_tm(to_device(batch["inputs"], dev))
        losses = ctc_loss_from_logits(
            logits,
            to_device(batch["labels"], dev),
            to_device(batch["input_length"], dev),
            to_device(batch["label_length"], dev),
            trim_frames=cfg.ctc.trim_frames,
            time_major=True,
        )
        return losses.mean()

    return step


def make_predict_step(model: nn.Module) -> Callable[[Any], torch.Tensor]:
    """Returns step(inputs) -> (B, T, C) softmax probabilities."""
    dev = model_device(model)

    @torch.inference_mode()
    def step(inputs) -> torch.Tensor:
        return torch.softmax(model(to_device(inputs, dev)), dim=-1)

    return step


def make_decode_step(
    model: nn.Module, *, threshold: float, trim_frames: int = 2,
    drop_blank: bool = False,
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Predict and best-path decode on the device.

    Returns step(inputs, input_lengths=None) -> (best, emit), (B, T')
    int32 argmax classes and the bool emit mask: only these reach the
    host, not the (B, T, C) posteriors."""
    blank = model.config.nb_classes - 1 if drop_blank else None
    dev = model_device(model)

    @torch.inference_mode()
    def step(inputs, input_lengths: Optional[Any] = None):
        probs = torch.softmax(model(to_device(inputs, dev)), dim=-1)
        lengths = None if input_lengths is None else to_device(input_lengths, dev)
        return best_path_decode(
            probs, lengths,
            threshold=threshold, trim_frames=trim_frames, blank=blank,
        )

    return step
