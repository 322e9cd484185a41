"""Charging the traced window's device work and idle time to the port's
own spans.

The port opens spans named ``mgr.<layer>.<part>`` while a profiler runs
(``mgr_tpu_torch/core/tracing.py::annotate``); they land in the same
trace as the benchmark's ``bench.window`` and ``port.*`` spans and the
card's kernels and copies. Three steps:

1. Each kernel, copy and memset in the window is joined to the CUDA
   runtime or driver call that launched it, by ``args.correlation``.
2. That launch is charged to the ``mgr.*`` spans open around it on its own
   thread. Where none is open and the launch sits inside a backward op
   (autograd's device thread), it is charged to the spans open around the
   forward op that made that backward op: the backward op's pair
   (``Sequence number``, ``Fwd thread id``) is found at the end of a
   ``fwdbwd`` flow, whose start is the forward op. (A sequence number
   alone is not enough: a remat recompute runs forward ops with their own
   numbers on autograd's thread.)
3. The device's idle time in the window is charged to the ``mgr.*`` spans
   open on the window's thread, each gap split where those spans change.

A charge names every ``mgr.*`` span open at its point, innermost last, so
a span's share counts what is charged inside it, nested spans included.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark import trace

PREFIX = "mgr."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SEQ, FWD_TID = "Sequence number", "Fwd thread id"

Stack = Tuple[dict, ...]


@dataclasses.dataclass
class Charges:
    """The window's device events, each with the spans it is charged to
    (``work``), the idle pieces with theirs (``idle``: start, end, spans),
    how many device events were joined to their launch (``joined``), and
    the names of the ``mgr.*`` spans in the trace (``names``)."""

    work: List[Tuple[dict, Stack]]
    idle: List[Tuple[float, float, Stack]]
    joined: int
    names: frozenset


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def _open_at(intervals: Sequence[dict], points: Sequence[float]) -> List[Stack]:
    """For each time in ``points`` (sorted), the ``intervals`` of one
    thread (nested, as a thread's ranges are) open at it, outermost
    first."""
    order = sorted(intervals, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, j = [], [], 0
    for p in points:
        while j < len(order) and order[j]["ts"] <= p:
            while stack and _end(stack[-1]) < order[j]["ts"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and _end(stack[-1]) < p:
            stack.pop()
        out.append(tuple(e for e in stack if _end(e) >= p))
    return out


def _by_thread(events: Iterable[dict]) -> Dict[object, List[dict]]:
    out: Dict[object, List[dict]] = defaultdict(list)
    for e in events:
        out[e.get("tid")].append(e)
    return out


def _stacks(intervals: Dict[object, List[dict]], queries: List[Tuple[object, float, int]],
            ) -> Dict[int, Stack]:
    """The ``intervals`` (by thread) open at each query (thread, time,
    key), by key."""
    out: Dict[int, Stack] = {}
    by_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for tid, ts, key in queries:
        by_tid[tid].append((ts, key))
    for tid, qs in by_tid.items():
        qs.sort()
        for (_, key), st in zip(qs, _open_at(intervals.get(tid, []), [t for t, _ in qs])):
            out[key] = st
    return out


def _forward_points(ops: List[dict], events: List[dict]) -> Dict[tuple, Tuple[object, float]]:
    """(sequence number, forward thread id) of each backward op at the end
    of a ``fwdbwd`` flow -> where the flow starts: the forward op's thread
    and start."""
    at = {(e.get("tid"), e["ts"]): e for e in ops if e["args"].get(FWD_TID)}
    flows: Dict[object, dict] = {}
    for f in events:
        if f.get("cat") == "fwdbwd" and f.get("ph") in ("s", "f"):
            flows.setdefault(f.get("id"), {})[f["ph"]] = f
    points: Dict[tuple, Tuple[object, float]] = {}
    for pair in flows.values():
        s, f = pair.get("s"), pair.get("f")
        bwd = at.get((f.get("tid"), f["ts"])) if s and f else None
        if bwd is not None:
            points[(bwd["args"][SEQ], bwd["args"][FWD_TID])] = (s.get("tid"), s["ts"])
    return points


def charge(events: Optional[List[dict]]) -> Optional[Charges]:
    """The window's charges; None without a window or device events."""
    w = trace.window(events) if events is not None else None
    if w is None:
        return None
    start, end = w["ts"], _end(w)
    dev = trace.device_events(events, start, end)
    if not dev:
        return None
    done = trace.complete(events)
    spans = _by_thread(e for e in done if e.get("cat") == "user_annotation"
                       and e.get("name", "").startswith(PREFIX))
    launch = {e["args"]["correlation"]: e for e in done
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    pairs = [(d, launch.get(d.get("args", {}).get("correlation"))) for d in dev]
    joined = [(i, r) for i, (_, r) in enumerate(pairs) if r is not None]
    own = _stacks(spans, [(r.get("tid"), r["ts"], i) for i, r in joined])

    # Launches outside every span of their thread: the backward op around them.
    ops = [e for e in done if e.get("cat") == "cpu_op" and SEQ in e.get("args", {})]
    orphans = [(i, r) for i, r in joined if not own[i]]
    stacks: Dict[int, Stack] = {i: own[i] for i, _ in joined}
    if orphans and ops:
        bwd_ops = _by_thread(e for e in ops if e["args"].get(FWD_TID))
        inside = _stacks(bwd_ops, [(r.get("tid"), r["ts"], i) for i, r in orphans])
        points = _forward_points(ops, events)
        made = [(i, points.get((st[-1]["args"][SEQ], st[-1]["args"][FWD_TID])))
                for i, st in inside.items() if st]
        stacks.update(_stacks(spans, [(p[0], p[1], i) for i, p in made if p is not None]))
    work = [(d, stacks.get(i, ())) for i, (d, _) in enumerate(pairs)]

    # Idle: the gaps between the window's device intervals, split by the
    # spans open on the window's thread.
    gaps, t = [], start
    for a, b in trace.union((d["ts"], _end(d)) for d in dev):
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    mine = spans.get(w.get("tid"), [])
    cuts = sorted({e["ts"] for e in mine} | {_end(e) for e in mine})
    between = _open_at(mine, [(a + b) / 2 for a, b in zip(cuts, cuts[1:])])
    idle = []
    for a, b in gaps:
        edges = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for p, q in zip(edges, edges[1:]):
            k = bisect.bisect_right(cuts, (p + q) / 2) - 1
            idle.append((p, q, between[k] if 0 <= k < len(between) else ()))
    names = frozenset(e["name"] for es in spans.values() for e in es)
    return Charges(work=work, idle=idle, joined=len(joined), names=names)


def _inside(stack: Stack, name: str) -> bool:
    return any(e["name"] == name for e in stack)


def _per_call(record: dict, events, name: str):
    c = charge(events)
    if c is None or name not in c.names or not record["calls"]:
        return None, 0
    return c, len(record["calls"])


def work_ms(record: dict, events, name: str) -> Optional[float]:
    """Device time of the work charged to ``name``, ms a call."""
    c, n = _per_call(record, events, name)
    if c is None:
        return None
    return sum(d["dur"] for d, st in c.work if _inside(st, name)) / 1e3 / n


def idle_ms(record: dict, events, name: str) -> Optional[float]:
    """Device idle time charged to ``name``, ms a call."""
    c, n = _per_call(record, events, name)
    if c is None:
        return None
    return sum(b - a for a, b, st in c.idle if _inside(st, name)) / 1e3 / n


def extent_ms(record: dict, events, name: str) -> Optional[float]:
    """For each ``name`` span, the device time from the first start to the
    last end of the work launched inside it (its kernels and the idle
    between them), ms; summed over the window's spans, a call."""
    c, n = _per_call(record, events, name)
    if c is None:
        return None
    reach: Dict[int, List[float]] = {}
    for d, st in c.work:
        span = next((e for e in reversed(st) if e["name"] == name), None)
        if span is not None:
            r = reach.setdefault(id(span), [d["ts"], _end(d)])
            r[0], r[1] = min(r[0], d["ts"]), max(r[1], _end(d))
    return sum(b - a for a, b in reach.values()) / 1e3 / n
