"""ROI crop and resize for the rgb stream (``mgr_tpu/ops/image.py``): a
per-frame upper-body box from the skeleton, resampled to 60x60.

The JAX package resamples with ``jax.image.scale_and_translate(method=
"cubic")``, whose defaults are ``antialias=True`` and f32 products.
``F.interpolate(mode="bicubic")`` is another filter (Keys a=-0.75, no
widening when it shrinks), so the weights are built here as JAX's
``compute_weight_mat`` builds them:
  * the Keys cubic with a=-0.5;
  * its argument divided by max(1/scale, 1), so a box that shrinks k-fold
    widens the kernel k-fold (the antialias);
  * each output sample's weights divided by their sum, and zero where
    |sum| <= 1000 * eps(f32);
  * zero where the sample centre lies outside [-0.5, in - 0.5].
The box differs per frame, so a video of T frames is two batched f32
products (TF32 off) with weights (T, 60, H) and (T, W, 60), built on the
device of the frames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mgr_tpu_torch.ops.precision import f32_matmul

FALLBACK_BOX = (0.0, 330.0, 0.0, 640.0)  # up, down, left, right
CHUNK_FRAMES = 256  # frames resampled per pair of products
_SUM_FLOOR = 1000.0 * float(np.finfo(np.float32).eps)


def upper_body_box(hip_xy: torch.Tensor, shc_xy: torch.Tensor,
                   width: int = 640, height: int = 480) -> torch.Tensor:
    """(..., 2) hip and shoulder-centre -> (..., 4) boxes [up, down, left,
    right]: shcY-120 .. hipY+120, hipX-180 .. hipX+180, clipped to
    [1, size - 1]."""
    up = (shc_xy[..., 1] - 120.0).clamp(1.0, height - 1.0)
    down = (hip_xy[..., 1] + 120.0).clamp(1.0, height - 1.0)
    left = (hip_xy[..., 0] - 180.0).clamp(1.0, width - 1.0)
    right = (hip_xy[..., 0] + 180.0).clamp(1.0, width - 1.0)
    return torch.stack([up, down, left, right], dim=-1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic, a=-0.5, of x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """(N,) f32 scales and translations -> (N, in_size, out_size) weights:
    output sample j reads input pixel i with weight [n, i, j]."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = inv_scale.clamp_min(1.0)[:, :, None]
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)
    x = (sample_f[:, None, :]
         - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > _SUM_FLOOR,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def crop_resize_frames(frames: torch.Tensor, boxes: torch.Tensor,
                       out_dim: int = 60) -> torch.Tensor:
    """(N, H, W) gray frames + (N, 4) f32 boxes [up, down, left, right] ->
    (N, out_dim, out_dim) cubic-resampled crops, in f32."""
    up, down, left, right = boxes.unbind(-1)
    h = (down - up).clamp_min(1.0)
    w = (right - left).clamp_min(1.0)
    H, W = frames.shape[-2:]
    w_rows = resample_weights(H, out_dim, out_dim / h, -up * out_dim / h)
    w_cols = resample_weights(W, out_dim, out_dim / w, -left * out_dim / w)
    rows = f32_matmul(w_rows.transpose(1, 2), frames.float())
    return f32_matmul(rows, w_cols)


def crop_resize_frame(frame: torch.Tensor, box: torch.Tensor, out_dim: int = 60) -> torch.Tensor:
    """(H, W) gray frame + (4,) box -> (out_dim, out_dim)."""
    return crop_resize_frames(frame[None], box[None], out_dim)[0]


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> (...) luma with OpenCV's BGR2GRAY weights, in f32."""
    frame = frame.float()
    r, g, b = frame[..., 2], frame[..., 1], frame[..., 0]
    return 0.299 * r + 0.587 * g + 0.114 * b


def extract_upper_body_video(video: torch.Tensor, hip: torch.Tensor, shc: torch.Tensor,
                             out_dim: int = 60,
                             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, H, W) gray video (any real dtype) + (T, 2) f32 hip and
    shoulder-centre tracks -> (T, out_dim, out_dim, 1) f32 crops, on the
    video's device. Frames where ``valid`` (T,) is false use
    :data:`FALLBACK_BOX`. The frames are cast to f32 a chunk at a time."""
    boxes = upper_body_box(hip.float(), shc.float())
    if valid is not None:
        fb = torch.tensor(FALLBACK_BOX, dtype=torch.float32, device=boxes.device)
        boxes = torch.where(valid[:, None], boxes, fb[None, :])
    out = torch.cat([crop_resize_frames(video[i:i + CHUNK_FRAMES], boxes[i:i + CHUNK_FRAMES],
                                        out_dim)
                     for i in range(0, video.shape[0], CHUNK_FRAMES)])
    return out[..., None]
