"""Products in true f32: the featurizers' matmuls (``mgr_tpu/ops/mfcc.py``,
``mgr_tpu/ops/image.py``) run at f32 precision in the JAX package, and
PyTorch lets cuBLAS round f32 operands to TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set."""

from __future__ import annotations

import torch


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched as ``torch.matmul``) with TF32 off for the call,
    the global flag restored after it."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = saved
