"""Each metric's reader on a canned profiler trace and run record, against
hand arithmetic."""

import json
import math
from pathlib import Path

import pytest

from benchmark import harness, roofline, trace
from conftest import ROOT

SPEC = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())


def X(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
    X("user_annotation", "bench.window", 1000.0, 1000.0),
    X("user_annotation", "port.decode_batches", 1000.0, 400.0),
    X("user_annotation", "port.decode_batches", 1500.0, 400.0),
    X("cpu_op", "aten::mm", 1020.0, 30.0),
    X("cpu_op", "aten::copy_", 1390.0, 30.0),
    X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1010.0, 50.0, tid=7),
    X("kernel", "void (anonymous namespace)::lstm_fwd_kernel<false>(...)", 1100.0, 200.0, tid=7),
    X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1510.0, 50.0, tid=7),
    X("kernel", "void (anonymous namespace)::lstm_fwd_kernel<false>(...)", 1600.0, 200.0, tid=7),
    X("kernel", "void (anonymous namespace)::lstm_bwd_kernel<false>(...)", 1800.0, 100.0, tid=7),
    X("kernel", "void ctc_fwd_kernel(...)", 1900.0, 20.0, tid=7),
    X("kernel", "void ctc_bwd_kernel(...)", 1920.0, 30.0, tid=7),
    X("kernel", "outside the window", 2500.0, 100.0, tid=7),
]
RECORD = {
    "setup_s": 3.0, "window_s": 1.0, "items": 2, "memory_peak_bytes": 2 ** 31,
    "calls": [(0.0, 0.4, 1), (0.5, 0.9, 1)], "flops_per_call": 1e9,
    "lstm": {"T": 1900, "B": 1, "H": 500, "store_c": False},
    "ctc": {"T": 1898, "B": 1, "K": 44, "N": 150, "visits": [1898 * 33.0, 1898 * 41.0]},
}
BUSY_US = 50 + 200 + 50 + 200 + 100 + 20 + 30


def _read(name, events=EVENTS):
    return harness.load_module("metrics", name).read(RECORD, events)


def test_trace_window_and_busy():
    assert trace.busy_and_window_us(EVENTS) == (BUSY_US, 1000.0)
    assert trace.kernel_time(EVENTS, "lstm_fwd_kernel") == (2, 400.0)
    assert trace.memcpy_time(EVENTS, "HtoD") == (2, 100.0)


def test_end_to_end_readers():
    assert _read("setup_s", None) == 3.0
    assert _read("train_seq_per_s", None) == _read("decode_seq_per_s", None) == 2.0
    assert _read("train_host_seq_per_s", None) == 2.0
    assert math.isclose(_read("infer_p95_ms", None), 400.0)
    assert _read("peak_mem_gib", None) == 2.0


@pytest.mark.parametrize("suffix", ["train", "train_host", "decode", "infer"])
def test_device_readers(suffix):
    assert math.isclose(_read(f"device_idle_pct.{suffix}"), 100.0 * (1 - BUSY_US / 1000.0))
    assert math.isclose(_read(f"mfu.{suffix}"), 100.0 * 2e9 / 1e-3 / 989e12)
    k1 = roofline.lstm_bound(1900, 1, 500, dirs=2, backward=False, store_c=False)["bound_ms"]
    assert math.isclose(_read(f"k1_roofline.{suffix}"), 100.0 * 2 * k1 * 1e3 / 400.0)
    for name in (f"device_idle_pct.{suffix}", f"mfu.{suffix}", f"k1_roofline.{suffix}"):
        assert _read(name, None) is None


def test_kernel_and_copy_readers():
    k2 = roofline.lstm_bound(1900, 1, 500, dirs=2, backward=True, store_c=False)["bound_ms"]
    for suffix in ("train", "train_host"):
        assert math.isclose(_read(f"k2_roofline.{suffix}"), 100.0 * k2 * 1e3 / 100.0)
    c = RECORD["ctc"]
    least = sum(roofline.ctc_bound(1898, 1, 44, 150, v, backward=False, store=True)["bound_ms"]
                + roofline.ctc_bound(1898, 1, 44, 150, v, backward=True)["bound_ms"]
                for v in c["visits"])
    for suffix in ("train", "train_host"):
        assert math.isclose(_read(f"ctc_roofline.{suffix}"), 100.0 * least * 1e3 / 50.0)
    assert math.isclose(_read("h2d_ms.train_host"), 0.05)
    assert math.isclose(_read("h2d_ms.decode"), 0.05)
    # each request's span less the device's busy time inside it: 400 - 250 and 400 - 350
    assert math.isclose(_read("host_ms.infer"), 0.1)


def test_a_reader_with_nothing_to_read_returns_none():
    bare = [e for e in EVENTS if e.get("cat") != "kernel"]
    assert _read("k1_roofline.train", bare) is None
    assert _read("ctc_roofline.train", bare) is None


def test_breakdown():
    b = trace.breakdown(EVENTS)
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("void (anonymous namespace)::lstm_fwd_kernel")
    assert math.isclose(b["device_ops"][0][1], 400e-6)
    assert "outside the window" not in names
    idle = dict(b["idle_gaps"])
    assert math.isclose(sum(idle.values()), (1000.0 - BUSY_US) / 1e6)
    # the gap 1060-1100 falls inside port.decode_batches with no op open
    assert "port.decode_batches" in idle
    # the gap 1300-1510 has its midpoint 1405 in aten::copy_ (1390-1420), after the span
    assert "aten::copy_" in idle and "(no host op)" in idle


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (Path(ROOT) / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
