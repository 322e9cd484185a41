"""Kernel dispatch rule and launch counters.

Counterpart of ``mgr_tpu/ops/dispatch.py``, reduced to one rule: a
tensor on a CUDA device goes to the hand-written kernel, a tensor on the
CPU goes to the kernel's plain PyTorch version. There is no mode switch
and no environment variable, and a CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

Each kernel wrapper adds one to its counter where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels (``chip_smoke.py`` resets the counters, drives the
serving, training and mesh paths and reads them back). The entries of K1's
and K2's sources also count the launches that took the tiling of two batch
groups.

The direction-shard context is the counterpart of ``direction_shard`` /
``direction_shard_axis``: the mesh steps of the shard_map route set it,
and ``ops.lstm.bilstm_layer_tm`` takes the single-direction path under it.
The H-shard context is this rank's place on the GSPMD route, where XLA
partitions the step in the JAX package: the mesh steps of that route set
it, ``ops.lstm.bilstm_layer_tm`` takes the H-sharded path under it, and
the noise and dropout draws (:func:`draw_local`) are made at the global
shape and cut to this rank's rows and time slice.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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

# The entries of K1's and K2's sources (K1, K5a, K6a; K2, K5b, K6b) and,
# apart from _launches, their launches that ran in two batch groups
# (``kernels/bilstm_tm.py::batch_groups``).
GROUPED = ("bilstm_tm_fwd", "lstm_tm_fwd", "lstm_scan_fwd",
           "bilstm_tm_bwd", "lstm_tm_bwd", "lstm_scan_bwd")
_grouped: Dict[str, int] = {name: 0 for name in GROUPED}


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


@dataclasses.dataclass(frozen=True)
class HShard:
    """This rank's place on the GSPMD route of a ``config``
    (``core.config.MeshConfig``) mesh: its data index (its rows of the
    batch), the process group of its model axis and its index there (each
    rank computes a block of every LSTM's hidden units that the axis
    divides) and of its time axis (each rank projects a contiguous slice
    of the time steps)."""

    config: Any  # core.config.MeshConfig
    data_index: int
    model_group: Any  # torch.distributed.ProcessGroup
    model_index: int
    time_group: Any
    time_index: int

    @property
    def data(self) -> int:
        return self.config.data

    @property
    def model(self) -> int:
        return self.config.model

    @property
    def time(self) -> int:
        return self.config.time


_H_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "mgr_tpu_torch_h_shard", default=None)


class h_shard:
    """Context: the model inside runs this rank's part of the GSPMD route
    (``mgr_tpu/train/step.py:233-290``, where XLA partitions the step)."""

    def __init__(self, shard: HShard):
        self._shard = shard
        self._token = None

    def __enter__(self) -> HShard:
        self._token = _H_SHARD.set(self._shard)
        return self._shard

    def __exit__(self, *exc) -> None:
        _H_SHARD.reset(self._token)


def h_shard_context() -> Optional[HShard]:
    """The active :class:`HShard`, else None."""
    return _H_SHARD.get()


def local_time(x_tm: torch.Tensor) -> torch.Tensor:
    """Under an H-shard context, this rank's slice of the whole time-major
    stream ``x_tm`` (T, ...) (all of it without a time axis); else
    ``x_tm``."""
    shard = _H_SHARD.get()
    if shard is None:
        return x_tm
    n = x_tm.shape[0] // shard.time
    return x_tm[shard.time_index * n:(shard.time_index + 1) * n]


def draw_local(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Tuple[int, ...], *,
               batch_axis: int, time_axis: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)``, a random draw of a tensor of this rank's
    ``shape``. Under an H-shard context the draw is made at the global
    shape, as one process draws it (``batch_axis`` times the data ranks,
    ``time_axis``, where this rank holds a time slice, times the time
    ranks), with the same key, and this rank's rows and time slice are
    cut from it: the GSPMD step's draws are one device's."""
    shard = _H_SHARD.get()
    if shard is None:
        return draw(tuple(shape))
    full = list(shape)
    full[batch_axis] *= shard.data
    cuts = [(batch_axis, shard.data_index)]
    if time_axis is not None:
        full[time_axis] *= shard.time
        cuts.append((time_axis, shard.time_index))
    x = draw(tuple(full))
    for axis, i in cuts:
        x = x.narrow(axis, i * shape[axis], shape[axis])
    return x


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


def count_launch(name: str, *, grouped: bool = False) -> None:
    _launches[name] += 1
    if grouped:
        _grouped[name] += 1


def reset_launch_counts() -> None:
    for counts in (_launches, _grouped):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def grouped_counts() -> Dict[str, int]:
    """Launches of K1's and K2's sources that ran in two batch groups, by
    entry."""
    return dict(_grouped)
