"""Kernel dispatch rule and launch counters.

Counterpart of ``mgr_tpu/ops/dispatch.py``, reduced to one rule: a
tensor on a CUDA device goes to the hand-written kernel, a tensor on the
CPU goes to the kernel's plain PyTorch version. There is no mode switch
and no environment variable, and a CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

Each kernel wrapper adds one to its counter where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels (``chip_smoke.py`` resets the counters, drives the
serving, training and mesh paths and reads them back).

The direction-shard context is the counterpart of ``direction_shard`` /
``direction_shard_axis``: the mesh steps set it, and
``ops.lstm.bilstm_layer_tm`` takes the single-direction path under it.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch

KERNELS = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd",
           "lstm_tm_fwd", "lstm_tm_bwd", "lstm_scan_fwd", "lstm_scan_bwd")

# The source under csrc/ of each kernel's C entry: K5a/K5b (one direction)
# and K6a/K6b (the batch-major scan) are further entries of K1's and K2's
# sources.
SOURCES = {"bilstm_tm_fwd": "bilstm_tm_fwd", "bilstm_tm_bwd": "bilstm_tm_bwd",
           "ctc_fwd": "ctc_fwd", "ctc_bwd": "ctc_bwd",
           "lstm_tm_fwd": "bilstm_tm_fwd", "lstm_tm_bwd": "bilstm_tm_bwd",
           "lstm_scan_fwd": "bilstm_tm_fwd", "lstm_scan_bwd": "bilstm_tm_bwd"}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}


@dataclasses.dataclass(frozen=True)
class DirectionShard:
    """This rank's part of the direction-sharded tensor-parallel path: the
    process group of the model axis (two ranks) and the BLSTM direction
    this rank computes (its index on that axis)."""

    group: Any  # torch.distributed.ProcessGroup
    direction: int


_DIR_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "mgr_tpu_torch_direction_shard", default=None)


class direction_shard:
    """Context: BLSTM layers inside split their two scan directions over
    ``group`` (``mgr_tpu/ops/dispatch.py:63-75``): this rank runs
    direction ``direction`` only, then the h streams are exchanged."""

    def __init__(self, group: Any, direction: int):
        if direction not in (0, 1):
            raise ValueError(f"direction must be 0 or 1, got {direction}")
        self._shard = DirectionShard(group, direction)
        self._token = None

    def __enter__(self) -> DirectionShard:
        self._token = _DIR_SHARD.set(self._shard)
        return self._shard

    def __exit__(self, *exc) -> None:
        _DIR_SHARD.reset(self._token)


def direction_shard_context() -> Optional[DirectionShard]:
    """The active :class:`DirectionShard`, else None
    (``direction_shard_axis``)."""
    return _DIR_SHARD.get()


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version).

    Raises on a mix of devices or on any other device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"kernel operands must all be on one CUDA device or all on the "
        f"CPU, got {sorted(kinds)}"
    )


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)
