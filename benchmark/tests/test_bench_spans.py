"""The port's spans charged with their device work and idle time
(benchmark/spans.py) on a canned chrome trace, against hand arithmetic:
two host threads, kernels joined to their launches by correlation, a
backward kernel charged through the forward-backward link, an idle gap
split across two spans, and a kernel that no span holds."""

import math

import pytest

from benchmark import harness, spans

MAIN, AUTOGRAD, STREAM = 1, 2, 7
NEW = {"proj_ms.train": "mgr.lstm.projection", "opt_ms.train": "mgr.step.optimizer",
       "cnn_ms.train_host": "mgr.cnn.frontend", "proj_ms.decode": "mgr.lstm.projection",
       "tokens_idle_ms.decode": "mgr.decode.tokens", "input_idle_ms.infer": "mgr.decode.input",
       "launch_idle_ms.infer": "mgr.decode.forward", "tokens_idle_ms.infer": "mgr.decode.tokens"}


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def launch(ts, corr, tid=MAIN):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 4.0, tid, correlation=corr)


def kernel(name, ts, dur, corr=None, cat="kernel"):
    args = {} if corr is None else {"correlation": corr}
    return X(cat, name, ts, dur, STREAM, **args)


SEQ, FWD = spans.SEQ, spans.FWD_TID
EVENTS = [
    X("user_annotation", "bench.window", 0.0, 1000.0),
    X("user_annotation", "port.train_step", 0.0, 1000.0),
    # forward: the projection's GEMM, launched inside its span
    X("user_annotation", "mgr.lstm.projection", 100.0, 100.0),
    X("cpu_op", "_MatmulF32", 110.0, 20.0, **{SEQ: 5, FWD: 0}),
    launch(115.0, 1), kernel("gemm forward", 120.0, 30.0, 1),
    # a kernel no span holds
    launch(300.0, 5), kernel("lstm_fwd_kernel", 300.0, 100.0, 5),
    # backward on autograd's thread: charged to the projection by the link
    X("cpu_op", "autograd::engine::evaluate_function: _MatmulF32Backward", 450.0, 50.0,
      AUTOGRAD, **{SEQ: 5, FWD: 1}),
    X("cpu_op", "_MatmulF32Backward", 452.0, 40.0, AUTOGRAD, **{SEQ: 5, FWD: 1}),
    # a forward op of a remat recompute: sequence numbers repeat across threads
    X("cpu_op", "aten::relu", 455.0, 2.0, AUTOGRAD, **{SEQ: 5, FWD: 0}),
    launch(460.0, 2, AUTOGRAD), kernel("cutlass_80_simt_sgemm", 470.0, 50.0, 2),
    {"ph": "s", "id": 9, "pid": 1, "tid": MAIN, "ts": 110.0, "cat": "fwdbwd", "name": "fwdbwd"},
    {"ph": "f", "id": 9, "pid": 1, "tid": AUTOGRAD, "ts": 452.0, "cat": "fwdbwd",
     "name": "fwdbwd", "bp": "e"},
    # the optimizer tail: two kernels, idle between them
    X("user_annotation", "mgr.step.optimizer", 600.0, 100.0),
    launch(610.0, 3), kernel("adam", 640.0, 20.0, 3),
    launch(620.0, 4), kernel("maxnorm", 680.0, 10.0, 4),
    # a decode call: the input copy, then the forward with a nested span
    X("user_annotation", "mgr.decode.input", 800.0, 50.0),
    launch(810.0, 6), kernel("Memcpy HtoD (Pageable -> Device)", 830.0, 10.0, 6, "gpu_memcpy"),
    X("user_annotation", "mgr.decode.forward", 850.0, 100.0),
    X("user_annotation", "mgr.lstm.projection", 900.0, 20.0),
    # a device event whose launch is not in the trace
    kernel("unjoined", 960.0, 5.0),
    kernel("outside the window", 2000.0, 10.0, 8),
]
RECORD = {"calls": [(0.0, 0.5, 1), (0.5, 1.0, 1)]}
CALLS = len(RECORD["calls"])


def _names(stack):
    return tuple(e["name"] for e in stack)


def test_kernels_are_joined_and_charged():
    c = spans.charge(EVENTS)
    by_kernel = {d["name"]: _names(st) for d, st in c.work}
    assert by_kernel == {
        "gemm forward": ("mgr.lstm.projection",),
        "lstm_fwd_kernel": (),
        "cutlass_80_simt_sgemm": ("mgr.lstm.projection",),  # through the sequence number
        "adam": ("mgr.step.optimizer",), "maxnorm": ("mgr.step.optimizer",),
        "Memcpy HtoD (Pageable -> Device)": ("mgr.decode.input",),
        "unjoined": ()}
    assert c.joined == 6 and len(c.work) == 7
    assert c.names == {"mgr.lstm.projection", "mgr.step.optimizer", "mgr.decode.input",
                       "mgr.decode.forward"}


def test_without_flows_a_backward_kernel_is_charged_to_nothing():
    """The sequence number alone does not decide: the recompute's forward
    op on autograd's thread carries the same one."""
    bare = [e for e in EVENTS if e.get("cat") != "fwdbwd"]
    by_kernel = {d["name"]: _names(st) for d, st in spans.charge(bare).work}
    assert by_kernel["cutlass_80_simt_sgemm"] == ()


def test_idle_is_split_where_spans_change():
    c = spans.charge(EVENTS)
    idle = {}
    for a, b, st in c.idle:
        idle[_names(st)] = idle.get(_names(st), 0.0) + (b - a)
    # gaps 0-120, 150-300, 400-470, 520-640, 660-680, 690-830, 840-960, 965-1000
    assert idle == {(): 100 + 100 + 70 + 80 + 100 + 10 + 35,
                    ("mgr.lstm.projection",): 20 + 50,
                    ("mgr.step.optimizer",): 40 + 20 + 10,
                    ("mgr.decode.input",): 30 + 10,
                    ("mgr.decode.forward",): 50 + 30,
                    ("mgr.decode.forward", "mgr.lstm.projection"): 20}
    assert math.isclose(sum(b - a for a, b, _ in c.idle), 1000 - 30 - 100 - 50 - 20 - 10 - 10 - 5)


def test_the_readers():
    assert math.isclose(spans.work_ms(RECORD, EVENTS, "mgr.lstm.projection"), 80 / 1e3 / CALLS)
    # a span's idle counts the spans nested in it
    assert math.isclose(spans.idle_ms(RECORD, EVENTS, "mgr.decode.forward"), 100 / 1e3 / CALLS)
    assert math.isclose(spans.idle_ms(RECORD, EVENTS, "mgr.lstm.projection"), 90 / 1e3 / CALLS)
    assert math.isclose(spans.idle_ms(RECORD, EVENTS, "mgr.decode.input"), 40 / 1e3 / CALLS)
    # first kernel start to last kernel end of the optimizer's launches
    assert math.isclose(spans.extent_ms(RECORD, EVENTS, "mgr.step.optimizer"), 50 / 1e3 / CALLS)
    assert math.isclose(harness.load_module("metrics", "opt_ms.train").read(RECORD, EVENTS),
                        50 / 1e3 / CALLS)
    assert harness.load_module("metrics", "proj_ms.train").read(RECORD, EVENTS) == \
        spans.work_ms(RECORD, EVENTS, "mgr.lstm.projection")
    # a span not in the trace reads nothing
    assert spans.idle_ms(RECORD, EVENTS, "mgr.decode.tokens") is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_new_reader_with_nothing_to_read_returns_none(name):
    read = harness.load_module("metrics", name).read
    assert read(RECORD, None) is None
    bare = [e for e in EVENTS if e.get("cat") not in ("kernel", "gpu_memcpy")]
    assert read(RECORD, bare) is None
    unspanned = [e for e in EVENTS if not e.get("name", "").startswith("mgr.")]
    assert read(RECORD, unspanned) is None
    with_span = EVENTS + [X("user_annotation", NEW[name], 970.0, 20.0)]
    assert read(RECORD, with_span) is not None
