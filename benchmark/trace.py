"""Reading the traced window: torch.profiler's chrome-trace events.

The harness wraps the window in a ``bench.window`` span and each call
into the port in a span named by the entry it calls (``port.*``). Device
work is the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; the
device is busy where at least one of them runs (the union of their
intervals). Times are the trace's microseconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.harness import WINDOW_SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160

Interval = Tuple[float, float]


def complete(events: Iterable[dict]) -> List[dict]:
    """The events with a start and a duration."""
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window(events: List[dict]) -> Optional[dict]:
    spans = [e for e in complete(events)
             if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN]
    return spans[0] if spans else None


def spans(events: List[dict], name: str) -> List[dict]:
    """The host spans called ``name`` (the harness's own annotations)."""
    return sorted((e for e in complete(events)
                   if e.get("cat") == "user_annotation" and e.get("name") == name),
                  key=lambda e: e["ts"])


def device_events(events: List[dict], start: float, end: float) -> List[dict]:
    """Device events that overlap [start, end]."""
    return [e for e in complete(events) if e.get("cat") in DEVICE_CATS
            and e["ts"] < end and e["ts"] + e["dur"] > start]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def covered(merged: List[Interval], start: float, end: float) -> float:
    """Length of [start, end] that the merged intervals cover."""
    return sum(max(0.0, min(b, end) - max(a, start)) for a, b in merged)


def busy_intervals(events: List[dict], start: float, end: float) -> List[Interval]:
    return union((e["ts"], e["ts"] + e["dur"]) for e in device_events(events, start, end))


def busy_and_window_us(events: List[dict]) -> Tuple[float, float]:
    """(device-busy microseconds inside the window, the window's length)."""
    w = window(events)
    if w is None:
        return 0.0, 0.0
    start, end = w["ts"], w["ts"] + w["dur"]
    return covered(busy_intervals(events, start, end), start, end), w["dur"]


def kernel_time(events: List[dict], name_part: str) -> Tuple[int, float]:
    """(launches, summed device microseconds) of the kernels in the window
    whose name contains ``name_part``."""
    w = window(events)
    if w is None:
        return 0, 0.0
    hits = [e for e in device_events(events, w["ts"], w["ts"] + w["dur"])
            if e.get("cat") == "kernel" and name_part in e.get("name", "")]
    return len(hits), sum(e["dur"] for e in hits)


def memcpy_time(events: List[dict], direction: str) -> Tuple[int, float]:
    """(copies, summed device microseconds) of the ``direction`` copies
    ("HtoD", "DtoH", ...) in the window."""
    w = window(events)
    if w is None:
        return 0, 0.0
    hits = [e for e in device_events(events, w["ts"], w["ts"] + w["dur"])
            if e.get("cat") == "gpu_memcpy" and direction in e.get("name", "")]
    return len(hits), sum(e["dur"] for e in hits)


def _host_stack_names(host: List[dict], points: List[float], tid) -> List[str]:
    """For each time in ``points`` (sorted), what the host thread ``tid``
    was doing: its innermost open op, with the ``port.*`` span it sits
    in, or "(no host op)"."""
    ops = sorted((e for e in host if e.get("tid") == tid), key=lambda e: (e["ts"], -e["dur"]))
    names, stack, j = [], [], 0
    for p in points:
        while j < len(ops) and ops[j]["ts"] <= p:
            stack.append(ops[j])
            j += 1
        stack = [e for e in stack if e["ts"] + e["dur"] >= p]
        inner = [e for e in stack if e.get("name") != WINDOW_SPAN]
        if not inner:
            names.append("(no host op)")
            continue
        port = next((e["name"] for e in inner if e["name"].startswith("port.")), None)
        leaf = min(inner, key=lambda e: e["dur"])["name"]
        names.append(leaf if port is None or port == leaf else f"{port} / {leaf}")
    return names


def breakdown(events: List[dict]) -> Dict[str, List[list]]:
    """The device operations that took most time in the window, and the
    device's idle time by what the host was doing meanwhile, each the ten
    largest [name, seconds]."""
    w = window(events)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    start, end = w["ts"], w["ts"] + w["dur"]
    dev = device_events(events, start, end)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.get("name", "?")[:NAME_CHARS]] += e["dur"] / 1e6
    merged = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, t = [], start
    for a, b in merged:
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    host = [e for e in complete(events) if e.get("cat") in HOST_CATS]
    mids = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    names = _host_stack_names(host, [mids[i] for i in order], w.get("tid"))
    idle: Dict[str, float] = defaultdict(float)
    for i, name in zip(order, names):
        a, b = gaps[i]
        idle[name[:NAME_CHARS]] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def self_host_us(events: List[dict], name: str) -> List[float]:
    """For each ``name`` span, its length less the device's busy time
    inside it."""
    out = []
    merged = None
    for s in spans(events, name):
        if merged is None:
            w = window(events)
            lo, hi = (w["ts"], w["ts"] + w["dur"]) if w else (s["ts"], float("inf"))
            merged = busy_intervals(events, lo, hi)
            starts = [a for a, _ in merged]
        a, b = s["ts"], s["ts"] + s["dur"]
        i = max(0, bisect.bisect_right(starts, a) - 1)
        busy = 0.0
        while i < len(merged) and merged[i][0] < b:
            busy += max(0.0, min(merged[i][1], b) - max(merged[i][0], a))
            i += 1
        out.append(s["dur"] - busy)
    return out
