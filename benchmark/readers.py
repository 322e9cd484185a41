"""What the metric readers (``benchmark/metrics/<metric>.py``) share.

Each reader is ``read(record, events) -> float | None``: ``record`` is the
run's own record (set-up and window seconds, every timed call's host start
and end and items, the peak of device memory, and the driver's shapes,
FLOPs and CTC lengths); ``events`` the traced window's profiler events
(None without ``--trace 1``). None means nothing to read, and the metric
is left out of the line.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from benchmark import roofline, trace

# The port's kernels, by the name of their __global__ function in
# mgr_tpu_torch/csrc/: K1 (bilstm_tm_fwd.cu), K2 (bilstm_tm_bwd.cu),
# K3 (ctc_fwd.cu), K4 (ctc_bwd.cu).
K1, K2, K3, K4 = "lstm_fwd_kernel", "lstm_bwd_kernel", "ctc_fwd_kernel", "ctc_bwd_kernel"
GIB = 2.0 ** 30


def per_second(record: Dict[str, Any]) -> Optional[float]:
    """All items of the window's calls over the window's seconds."""
    return record["items"] / record["window_s"] if record["calls"] else None


def latency_ms(record: Dict[str, Any], q: float) -> Optional[float]:
    """The q-quantile (nearest rank) of every call's host latency, ms."""
    lat = sorted(end - start for start, end, _ in record["calls"])
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(q * len(lat)) - 1)]


def _window_us(events) -> Optional[float]:
    w = trace.window(events) if events is not None else None
    return w["dur"] if w else None


def mfu_pct(record: Dict[str, Any], events) -> Optional[float]:
    """The model's FLOPs for the window's calls over the traced window,
    against the card's bf16 dense peak."""
    span = _window_us(events)
    if not span or not record["calls"]:
        return None
    flops = record["flops_per_call"] * len(record["calls"])
    return 100.0 * flops / (span / 1e6) / roofline.BF16_FLOPS


def idle_pct(record: Dict[str, Any], events) -> Optional[float]:
    """The share of the traced window in which no kernel or copy ran."""
    if events is None:
        return None
    busy, span = trace.busy_and_window_us(events)
    if not span or not busy:
        return None
    return 100.0 * (1.0 - busy / span)


def lstm_roofline_pct(record: Dict[str, Any], events, *, backward: bool) -> Optional[float]:
    """K1 (K2 with ``backward``): the launches' summed least time
    (``roofline.lstm_bound`` at the cell's shape) over their device time."""
    if events is None or "lstm" not in record:
        return None
    n, us = trace.kernel_time(events, K2 if backward else K1)
    if not n or not us:
        return None
    s = record["lstm"]
    b = roofline.lstm_bound(s["T"], s["B"], s["H"], dirs=2, backward=backward,
                            store_c=s["store_c"])
    return 100.0 * n * b["bound_ms"] * 1e3 / us


def ctc_roofline_pct(record: Dict[str, Any], events) -> Optional[float]:
    """K3 (with its alpha store) and K4 together: the least time of each
    call's CTC from its own lengths, over their device time."""
    if events is None or "ctc" not in record:
        return None
    n3, us3 = trace.kernel_time(events, K3)
    n4, us4 = trace.kernel_time(events, K4)
    if not (n3 and n4):
        return None
    c = record["ctc"]
    shape = (c["T"], c["B"], c["K"], c["N"])
    least_ms = sum(roofline.ctc_bound(*shape, v, backward=False, store=True)["bound_ms"]
                   + roofline.ctc_bound(*shape, v, backward=True)["bound_ms"]
                   for v in c["visits"])
    return 100.0 * least_ms * 1e3 / (us3 + us4)


def h2d_ms(record: Dict[str, Any], events) -> Optional[float]:
    """Device time of the host-to-device copies in the window, ms a call."""
    if events is None or not record["calls"]:
        return None
    n, us = trace.memcpy_time(events, "HtoD")
    return us / 1e3 / len(record["calls"]) if n else None


def host_ms(record: Dict[str, Any], events, span: str) -> Optional[float]:
    """Mean over the window's calls of the ``span`` span less the device's
    busy time inside it, ms."""
    if events is None:
        return None
    own: List[float] = trace.self_host_us(events, span)
    return sum(own) / len(own) / 1e3 if own else None
