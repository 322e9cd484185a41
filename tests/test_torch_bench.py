"""The port's bench (``mgr_tpu_torch/bench.py``) against the JAX package's
(``bench.py``, imported as a module; its ``main`` is not run): the same
seeded batch bit for bit, the same per-pipeline table, one JSON line with
the JAX line's keys for every pipeline and for ``--latency``, no run on
the CPU unless asked, and the decode path it times giving JAX's
``make_decode_step`` output exactly on the bench's batch.

On the CPU the bench drives the plain versions (``--device cpu``); the
loops are cut to one warm-up and one or two timed calls with
``monkeypatch`` (the module's own counts, no new flag). Rates measured
here are the CPU's and say nothing of the card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import bench as jbench  # the JAX package's bench.py at the repository root
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgr_tpu.core import config as jcfg
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train.step import make_decode_step as jdecode_step
from mgr_tpu_torch import bench, bridge
from mgr_tpu_torch.core import config as tcfg
from mgr_tpu_torch.decode.decoder import DECODE_SPECS
from mgr_tpu_torch.models.zoo import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PIPELINES = sorted(bench.PIPELINES)
TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "spread",
              "decode_seqs_per_sec_per_chip", "decode_spread", "pipeline", "batch"}
LATENCY_KEYS = {"metric", "value", "unit", "vs_baseline", "spread", "pipeline", "batch"}


def _port(cfg):
    return tcfg.PipelineConfig.from_json(cfg.to_json())


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.fixture
def short_loops(monkeypatch):
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    monkeypatch.setattr(bench, "TIMED_STEPS", 1)
    monkeypatch.setattr(bench, "REPEATS", 2)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_make_batch_is_the_jax_bench_batch(pipeline):
    cfg = jcfg.get_preset(pipeline).replace(maxlen=16, batch_size=2)
    want = jbench._make_batch(cfg, 2)
    got = bench._make_batch(_port(cfg), 2, "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        assert np.array_equal(got[k].numpy(), v), k


def test_pipeline_table_is_the_jax_bench_table():
    assert bench.PIPELINES == jbench.PIPELINES
    for name, spec in bench.PIPELINES.items():
        assert spec["threshold"] == DECODE_SPECS[name].threshold
    assert (bench.WARMUP_STEPS, bench.TIMED_STEPS, bench.REPEATS) == (
        jbench.WARMUP_STEPS, jbench.TIMED_STEPS, jbench.REPEATS)
    assert bench.REFERENCE_SEQS_PER_SEC == jbench.REFERENCE_SEQS_PER_SEC


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_main_prints_the_jax_line(pipeline, capsys, short_loops):
    argv = ["--pipeline", pipeline, "--device", "cpu", "--maxlen", "16", "--batch", "2"]
    if pipeline == "rgb":
        argv.append("--no-cnn-remat")
    assert bench.main(argv) == 0
    line = _line(capsys)
    assert set(line) == TRAIN_KEYS
    assert set(line["spread"]) == {"min", "max", "repeats"}
    assert set(line["decode_spread"]) == {"min", "max"}
    assert (line["metric"], line["unit"]) == ("train_seqs_per_sec_per_chip", "seq/s")
    assert (line["pipeline"], line["batch"], line["spread"]["repeats"]) == (pipeline, 2, 2)
    assert line["value"] > 0 and line["decode_seqs_per_sec_per_chip"] > 0
    assert 0 < line["spread"]["min"] <= line["value"] <= line["spread"]["max"]
    assert line["vs_baseline"] == round(line["value"] / 1.5, 2)


@pytest.mark.parametrize("pipeline", ["speech", "late_fusion"])
def test_latency_line(pipeline, capsys):
    assert bench.main(["--pipeline", pipeline, "--latency", "--device", "cpu",
                       "--maxlen", "16"]) == 0
    line = _line(capsys)
    assert set(line) == LATENCY_KEYS
    assert (line["metric"], line["unit"], line["batch"]) == ("decode_latency_ms", "ms", 1)
    assert line["spread"]["calls"] == 20
    assert 0 < line["spread"]["min"] <= line["value"] <= line["spread"]["max"]


def test_no_cnn_remat_reaches_the_model(monkeypatch, capsys, short_loops):
    from mgr_tpu_torch.models import zoo

    built, real = [], zoo.build_model

    def spy(cfg, *a, **kw):
        built.append(cfg.cnn.remat)
        return real(cfg, *a, **kw)

    monkeypatch.setattr(zoo, "build_model", spy)
    for flag in ([], ["--no-cnn-remat"]):
        bench.main(["--pipeline", "rgb", "--device", "cpu", "--maxlen", "4", "--batch", "1",
                    *flag])
    capsys.readouterr()
    assert built == [True, True, False, False]  # the train model, then the decode model


@pytest.mark.parametrize("module", [["mgr_tpu_torch.cli.main", "bench"], ["mgr_tpu_torch.bench"]])
def test_without_a_card_it_fails_and_names_device_cpu(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", *module], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout.strip() == ""  # no line, stale or otherwise


def _narrow(name):
    enc = jcfg.EncoderConfig(hidden=8, depth=2)
    cfg = jcfg.get_preset(name).replace(maxlen=16, encoder=enc)
    if name == "late_fusion":
        cfg = cfg.replace(fusion_hidden=8)
    return cfg


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_decode_path_matches_jax_on_the_bench_batch(pipeline):
    cfg = _narrow(pipeline)
    sources = ({k: _narrow(k) for k in ("speech", "skeletal")}
               if pipeline == "late_fusion" else None)
    jmodel = jbuild(cfg, sources)
    jparams = jax.jit(jmodel.init)(jax.random.key(cfg.seed))
    tmodel = bridge.load_params(
        build_model(_port(cfg), sources and {k: _port(v) for k, v in sources.items()},
                    device="cpu"),
        jax.tree.map(np.array, jparams))
    B, threshold = 3, bench.PIPELINES[pipeline]["threshold"]
    batch = jbench._make_batch(cfg, B)
    inputs = (batch["inputs"], batch["inputs2"]) if "inputs2" in batch else batch["inputs"]
    want_best, want_emit = jdecode_step(jmodel, threshold=threshold, trim_frames=2)(
        jparams, inputs, jnp.full((B,), cfg.maxlen, jnp.int32))
    best, emit = bench._decode_call(_port(cfg), tmodel, B, threshold, "cpu")()
    assert best.dtype == torch.int32 and emit.dtype == torch.bool
    assert np.array_equal(best.numpy(), np.asarray(want_best))
    assert np.array_equal(emit.numpy(), np.asarray(want_emit))


def test_latency_times_each_call_alone(monkeypatch):
    cfg = _port(_narrow("speech"))
    model = build_model(cfg, device="cpu")
    calls = []
    real = bench._decode_call

    def counted(*a, **kw):
        call = real(*a, **kw)
        return lambda: calls.append(1) or call()

    monkeypatch.setattr(bench, "_decode_call", counted)
    times = bench._bench_latency(cfg, model, 0.75, "cpu")
    assert len(times) == bench.LATENCY_CALLS and times == sorted(times)
    assert len(calls) == bench.LATENCY_CALLS + 1  # one warm-up call


def test_batch_is_on_the_device_before_the_timed_loop(monkeypatch, short_loops):
    """Every batch tensor the train step gets is a tensor on the bench's
    device, built before the first step (no host array reaches a step)."""
    from mgr_tpu_torch.train import step as step_lib

    seen = []
    real = step_lib.make_train_step

    def spy(model, *a, **kw):
        step = real(model, *a, **kw)

        def wrapped(state, batch, *r):
            seen.append({k: (type(v), getattr(v, "device", None)) for k, v in batch.items()})
            return step(state, batch, *r)
        return wrapped

    monkeypatch.setattr(step_lib, "make_train_step", spy)
    cfg = _port(_narrow("early_fusion"))
    bench._bench_train(cfg, 2, torch.device("cpu"))
    assert len(seen) == 1 + 2 * 1
    for s in seen:
        assert set(s) == {"inputs", "inputs2", "labels", "input_length", "label_length"}
        assert all(t is torch.Tensor and d == torch.device("cpu") for t, d in s.values())

