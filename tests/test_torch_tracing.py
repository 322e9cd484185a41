"""The port's spans (``core/tracing.py::annotate``): no profiler, no span
and no ``record_function`` call; under ``torch.profiler`` each layer's
span lands in the trace where its work runs, and a span's backward ops
carry the sequence number of a forward op inside it."""

import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.core import prng, tracing
from mgr_tpu_torch.decode.decoder import Decoder
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.train import step as step_lib

T, B, N = 12, 2, 3
SEQ, FWD = "Sequence number", "Fwd thread id"


def _trace(fn, tmp_path):
    """The complete events of ``fn()`` run under torch.profiler (CPU)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(events, name):
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == name), key=lambda e: e["ts"])


def _inside(e, span):
    return (e["tid"] == span["tid"] and span["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= span["ts"] + span["dur"])


def _batch(cfg, inputs):
    labels = np.full((B, N), -1, np.int32)
    labels[0, :2], labels[1, :1] = (1, 2), (3,)
    return {"inputs": inputs, "labels": labels, "label_length": np.array([2, 1], np.int32),
            "input_length": np.full((B,), T - cfg.ctc.trim_frames, np.int32)}


def _speech_cfg():
    return cfglib.get_preset("speech").replace(
        maxlen=T, batch_size=B, max_label_len=N, encoder=cfglib.EncoderConfig(hidden=6, depth=2))


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch, tmp_path):
    calls = []
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or record(name))
    span = tracing.annotate("mgr.test.off")
    assert span is tracing.annotate("mgr.test.other") and calls == []
    with span:
        pass
    assert calls == []

    def traced():
        with tracing.annotate("mgr.test.on"):
            torch.ones(2).sum()

    events = _trace(traced, tmp_path)
    assert calls == ["mgr.test.on"] and len(_spans(events, "mgr.test.on")) == 1


def test_train_step_spans_and_the_backward_link(tmp_path):
    cfg = _speech_cfg()
    model = build_model(cfg, seed=0, device="cpu")
    state = step_lib.create_train_state(model)
    step = step_lib.make_train_step(model)
    x = np.random.default_rng(0).standard_normal((B, T, cfg.num_feats)).astype(np.float32)
    key = prng.root_key(0)
    step(state, _batch(cfg, x), key)
    events = _trace(lambda: step(state, _batch(cfg, x), prng.fold_in(key, 1)), tmp_path)

    proj = _spans(events, "mgr.lstm.projection")
    opt = _spans(events, "mgr.step.optimizer")
    assert len(proj) == 4 and len(opt) == 1  # two layers x two directions; one tail
    assert all(p["ts"] + p["dur"] <= opt[0]["ts"] for p in proj)
    ops = [e for e in events if e.get("cat") == "cpu_op" and SEQ in e.get("args", {})]
    assert any(e["name"] == "aten::sqrt" and _inside(e, opt[0]) for e in ops)  # Adam's

    forward = {}
    for e in ops:
        if not e["args"].get(FWD):
            forward.setdefault(e["args"][SEQ], []).append(e)
    def made_by(name):
        backward = [e for e in ops if e["name"] == f"{name}Backward"]
        assert all(e["args"][FWD] for e in backward)
        made = [[f for f in forward[e["args"][SEQ]] if f["name"] == name] for e in backward]
        assert all(len(m) == 1 for m in made)
        return [sum(_inside(m[0], p) for p in proj) for m in made]

    assert made_by("_Projection") == [1] * 4  # two layers x two directions
    assert made_by("_MatmulF32") == [0]  # the head


def test_rgb_frontend_span_covers_the_remat_recompute(tmp_path):
    cfg = cfglib.get_preset("rgb").replace(
        maxlen=T, batch_size=B, max_label_len=N,
        cnn=cfglib.CNNConfig(img_dim=44, channels=(4, 6, 8), remat=True),
        encoder=cfglib.EncoderConfig(hidden=6, depth=2))
    model = build_model(cfg, seed=0, device="cpu")
    state = step_lib.create_train_state(model)
    step = step_lib.make_train_step(model)
    rng = np.random.default_rng(1)
    x = ((rng.integers(0, 256, (B, T, 44, 44, 1)) - 128.0) / 255.0).astype(np.float32)
    events = _trace(lambda: step(state, _batch(cfg, x), prng.root_key(2)), tmp_path)

    cnn = _spans(events, "mgr.cnn.frontend")
    assert len(cnn) == 2  # the forward, then the recompute inside the backward
    engine = [e for e in events if e["name"].startswith("autograd::engine::evaluate_function")]
    assert not any(_inside(cnn[0], e) for e in engine)
    assert any(_inside(cnn[1], e) for e in engine)
    for span in cnn:
        convs = [e for e in events if e["name"] == "_ConvValid" and _inside(e, span)]
        assert len(convs) == len(cfg.cnn.pool_sizes)


def test_decode_spans_in_order_inside_the_call(tmp_path):
    cfg = _speech_cfg()
    model = build_model(cfg, seed=0, device="cpu")
    decoder = Decoder.for_model(model, "speech")
    x = np.random.default_rng(3).standard_normal((B, T, cfg.num_feats)).astype(np.float32)
    batches = [((0, 1), _batch(cfg, x))]
    want = decoder.decode_batches(batches)

    def call():
        with torch.profiler.record_function("test.call"):
            assert decoder.decode_batches(batches) == want

    events = _trace(call, tmp_path)
    outer = _spans(events, "test.call")[0]
    names = ("mgr.decode.input", "mgr.decode.forward", "mgr.decode.tokens")
    found = [_spans(events, n) for n in names]
    assert [len(s) for s in found] == [1, 1, 1]
    found = [s[0] for s in found]
    assert all(_inside(s, outer) for s in found)
    assert [s["ts"] for s in found] == sorted(s["ts"] for s in found)
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(found, found[1:]))
    assert len([p for p in _spans(events, "mgr.lstm.projection")
                if _inside(p, found[1])]) == 4
