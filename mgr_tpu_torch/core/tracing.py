"""Profiling and numerics debugging (``mgr_tpu/core/tracing.py``), on
PyTorch's own tools.

  * ``annotate(name)``: the port's one span. While a profiler runs it is
    ``torch.profiler.record_function(name)``, a named range in the trace;
    otherwise a shared no-op, which costs one check. The program's spans
    are named ``mgr.<layer>.<part>``: ``mgr.lstm.projection``
    (``ops/lstm.py::input_projection``), ``mgr.cnn.frontend``
    (``models/layers.py::cnn_frontend``, its remat recompute too),
    ``mgr.step.optimizer`` (``train/step.py::_apply_updates``),
    ``mgr.decode.input`` and ``mgr.decode.forward`` (the decode step of
    ``train/step.py::make_decode_step``), ``mgr.decode.tokens``
    (``decode/decoder.py::Decoder.decode_batches``), and late fusion's
    ``mgr.fusion.towers`` (its two encoders) and ``mgr.fusion.layer`` (the
    concat and the fusion BiLSTM; ``models/zoo.py::LateFusionModel``). A
    backward op carries the sequence number of the forward op that made
    it, so a trace reader can charge a span's backward to it too.
  * ``trace(logdir)``: a ``torch.profiler`` trace of a block, the host's
    ops and, where there is a card, its kernels and copies, written to
    ``logdir`` by ``tensorboard_trace_handler`` (a ``*.pt.trace.json``
    that TensorBoard and Perfetto read); nothing when ``logdir`` is empty.
  * ``debug_nans(enable)``: the numerics check of the train and eval
    steps. It differs from ``jax_debug_nans``, which re-runs the first
    primitive that made a NaN and raises there: here the steps raise
    ``FloatingPointError`` when a loss (before its backward) or a
    gradient norm is not finite, which costs one host sync per step, and
    autograd's anomaly mode (``set_detect_anomaly(True, check_nan=True)``)
    raises naming the backward function that first returned a NaN. A NaN
    made inside a forward kernel shows at the loss, not at the kernel.
    On a mesh every rank reaches one verdict at the same step: a rank's
    own verdict is shared by a flag all-reduce before any rank raises,
    and the loss and gradient norm are checked after the collectives
    (``train.step``). With a model axis the backward holds the model
    group's collectives, so there anomaly mode's NaN check is off (a rank
    that raised inside the backward would leave its partner waiting): a
    NaN of the backward reaches the combined gradients and their norm.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch._C._autograd import _profiler_enabled

_debug_nans = False
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """``record_function(name)`` while a profiler runs, else the shared
    no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def debug_nans(enable: bool = True) -> None:
    global _debug_nans
    _debug_nans = bool(enable)
    torch.autograd.set_detect_anomaly(_debug_nans, check_nan=True)


def debugging_nans() -> bool:
    """Whether :func:`debug_nans` is on."""
    return _debug_nans


def is_nan_verdict(err: BaseException) -> bool:
    """Whether ``err`` is a verdict of :func:`debug_nans`: the steps' own
    ``FloatingPointError``, or anomaly mode's error naming the backward
    function that returned a NaN."""
    return isinstance(err, FloatingPointError) or (
        isinstance(err, RuntimeError) and "returned nan values" in str(err))


def check_finite(value: torch.Tensor, what: str) -> None:
    """Under :func:`debug_nans`, raise ``FloatingPointError`` when
    ``value`` holds a NaN or an Inf (a host sync); else nothing."""
    if _debug_nans and not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"debug_nans: the {what} is not finite: {value}")
