"""The late-fusion configuration and its decode cell: the cell loads from
the registry; the ``decode_fusion`` kind runs a tiny CPU cell to
``correct`` and makes its inputs from the seed; each decode fault, and
``fusion_faults.py``'s two-stream half batch, comes out not correct under
it; the late-fusion FLOP count and K1 launch shapes against hand
arithmetic; the two span readers and the K1 roofline at mixed widths on a
canned trace; the new reference imports neither JAX nor the port."""

import ast
import contextlib
import copy
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import faults, fusion_faults, fusion_flops, harness
from conftest import ROOT

FUSION = "late_fusion-decode-b64"
# At these widths the head drawn 20000x wider makes about a quarter of the
# frames clear 0.5, as 100 makes a third at the published widths.
TINY_FUSION = {"pipeline": {"maxlen": 24, "compute_dtype": "float32", "fusion_hidden": 4,
                            "max_label_len": 6},
               "params": {"batch": 4, "pool": 16, "sample_every": 2, "check_rows": 8,
                          "head_scale": 20000}}


def tiny_fusion_cell(**params):
    """The late-fusion cell at T=24, f32, towers of H=8 and H=6, fusion H=4."""
    over = copy.deepcopy(TINY_FUSION)
    over["params"].update(params)
    cell = harness.load_cell(FUSION, overrides=over)
    sources = copy.deepcopy(cell.config["sources"])
    sources["speech"]["encoder"]["hidden"] = 8
    sources["skeletal"]["encoder"]["hidden"] = 6
    cell.config = dict(cell.config, sources=sources)
    return cell


def _run(cell, fault=None, seed=424242, trace=False):
    with faults.planted(fault) if fault else contextlib.nullcontext():
        return harness.run(cell, seed, 0.3, trace, torch.device("cpu"), time.perf_counter())


def test_the_cell_loads_from_the_registry():
    lf = harness.load_cell(FUSION)
    assert (lf.kind, lf.config_name, lf.chips, lf.params["batch"]) == ("decode_fusion",
                                                                        "late_fusion", 1, 64)
    assert lf.config["reference"] == "late_fusion" and lf.config["reduced"] == []
    assert set(lf.config["sources"]) == {"speech", "skeletal"}
    assert lf.config["pipeline"]["name"] == "late_fusion"
    assert len(lf.config["decode"]["tokens"]) == lf.config["pipeline"]["nb_classes"] == 22
    assert {m["name"] for m in lf.per_layer} >= {"towers_ms.decode", "fuse_ms.decode",
                                                 "k1_roofline.fusion_decode", "mfu.decode",
                                                 "h2d_ms.decode"}
    assert "k1_roofline.decode" not in {m["name"] for m in lf.per_layer}
    assert {m["name"] for m in lf.end_to_end} == {"decode_seq_per_s", "peak_mem_gib", "setup_s"}


def test_the_configuration_holds_the_ports_presets():
    from mgr_tpu_torch.core.config import get_preset

    config = harness.load_cell(FUSION).config
    for name, raw in [("late_fusion", config["pipeline"])] + list(config["sources"].items()):
        assert json.loads(json.dumps(dataclasses.asdict(get_preset(name)))) == raw, name


def test_a_tiny_fusion_cell_is_correct():
    r = _run(tiny_fusion_cell())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["summary"]["uncompared"]["emitted"] > 20
    assert r["checks"]["class_gap"]["value"] < 1e-4


def test_a_traced_tiny_fusion_cell_reads_no_device_metric_on_the_cpu():
    r = _run(tiny_fusion_cell(), trace=True)
    assert r["correct"], r["checks"]
    device_only = {"towers_ms.decode", "fuse_ms.decode", "k1_roofline.fusion_decode"}
    assert not device_only & set(r["metrics"])
    assert r["metrics"]["mfu.decode"]["value"] > 0


def _inputs(seed):
    drv = harness.load_module("traffic", "decode_fusion").Driver(
        harness.Run(tiny_fusion_cell(), seed, torch.device("cpu")))
    drv.setup()
    data = {"pool": drv.pools[0], "pool2": drv.pools[1], "order": drv.order}
    data.update({f"w.{k}": v.numpy() for k, v in drv.p0.items()})
    return data


def test_same_seed_same_inputs():
    seed = 2**33 + 12345
    a, b, c = _inputs(seed), _inputs(seed), _inputs(seed + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    differ = {k for k in a if not np.array_equal(a[k], c[k])}
    assert {"pool", "pool2", "w.fusion.W", "w.speech.blstm_0.W"} <= differ


@pytest.mark.parametrize("fault", ["token_device", "token_host", "never_emits", "wrong_table"])
def test_a_decode_fault_is_not_correct(fault):
    r = _run(tiny_fusion_cell(), fault)
    assert not r["correct"], r["checks"]


def test_half_of_the_pairs_is_not_correct():
    with fusion_faults.half_pairs():
        r = _run(tiny_fusion_cell())
    assert not r["correct"], r["checks"]


def test_calibrate_plants_half_pairs_by_name(monkeypatch, capsys):
    """fusion_faults.py hands calibrate.py the two-stream fault by name, and
    gives faults.py its own planted back."""
    from benchmark import calibrate

    seen = []

    def fake_run(cell, seed, seconds, trace, dev, t0, substitute=None):
        from mgr_tpu_torch.decode import decoder as dec_mod

        seen.append(dec_mod.make_decode_step.__name__)
        return {"correct": False, "failed": 0, "checks": {"class_gap": {"value": 1.0}}}

    monkeypatch.setattr(calibrate.harness, "run", fake_run)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    before = faults.planted
    assert fusion_faults.main(["--workload", FUSION, "--fault", "half_pairs",
                               "--fault-seeds", "5"]) == 0
    assert seen == ["half_decode"] and faults.planted is before
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["what"], line["seed"], line["correct"]) == ("fault:half_pairs", 5, False)


def test_the_one_stream_half_batch_cannot_run_the_fusion_kind():
    """faults.py's half_batch slices one tensor; handed a pair it raises,
    and the run prints no result."""
    with pytest.raises(AttributeError):
        _run(tiny_fusion_cell(), "half_batch")


def test_late_fusion_flops_by_hand():
    config = {"pipeline": {"maxlen": 10, "fusion_hidden": 3, "nb_classes": 5},
              "sources": {"speech": {"num_feats": 4, "encoder": {"hidden": 2, "depth": 2}},
                          "skeletal": {"num_feats": 3, "encoder": {"hidden": 5, "depth": 1}}}}
    B = 2
    fr = 10 * B
    speech = 4 * fr * 4 * 8 + 4 * fr * 2 * 8 + 4 * fr * 4 * 8 + 4 * fr * 2 * 8
    skeletal = 4 * fr * 3 * 20 + 4 * fr * 5 * 20
    proj, rec, head = 4 * fr * 14 * 12, 4 * fr * 3 * 12, 2 * fr * 6 * 5
    assert math.isclose(fusion_flops.late_fusion_flops(config, B, train=False),
                        speech + skeletal + proj + rec + head)
    assert math.isclose(fusion_flops.late_fusion_flops(config, B, train=True),
                        speech + skeletal + 3 * (proj + rec + head) - proj)


def test_late_fusion_flops_at_the_cell():
    cell = harness.load_cell(FUSION)
    f = fusion_flops.late_fusion_flops(cell.config, cell.params["batch"], train=False)
    assert 3.0e12 < f < 3.1e12


MAIN, STREAM = 1, 7


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _launched(ts, corr, name, dur):
    return [X("cuda_runtime", "cudaLaunchKernel", ts, 2.0, correlation=corr),
            X("kernel", name, ts + 5.0, dur, STREAM, correlation=corr)]


EVENTS = ([X("user_annotation", "bench.window", 0.0, 1000.0),
           X("user_annotation", "port.decode_batches", 0.0, 1000.0),
           X("user_annotation", "mgr.decode.forward", 10.0, 900.0),
           X("user_annotation", "mgr.fusion.towers", 20.0, 400.0),
           X("user_annotation", "mgr.lstm.projection", 30.0, 20.0),
           X("user_annotation", "mgr.fusion.layer", 500.0, 300.0)]
          + _launched(35.0, 1, "gemm", 40.0) + _launched(100.0, 2, "lstm_fwd_kernel", 200.0)
          + _launched(320.0, 3, "lstm_fwd_kernel", 60.0)
          + _launched(510.0, 4, "cat", 10.0) + _launched(600.0, 5, "lstm_fwd_kernel", 30.0)
          + _launched(850.0, 6, "softmax", 8.0))


@pytest.mark.parametrize("metric,ms", [("towers_ms.decode", (40 + 200 + 60) / 2e3),
                                       ("fuse_ms.decode", (10 + 30) / 2e3)])
def test_the_fusion_span_readers(metric, ms):
    record = {"calls": [(0.0, 0.5, 64), (0.5, 1.0, 64)]}
    read = harness.load_module("metrics", metric).read
    assert math.isclose(read(record, EVENTS), ms)
    parent = [e for e in EVENTS if not e["name"].startswith("mgr.fusion")]
    assert read(record, parent) is None  # a program without the spans: nothing to read
    assert read(record, None) is None


def test_k1_launches_at_the_cell():
    cell = harness.load_cell(FUSION)
    assert [(s["T"], s["B"], s["H"]) for s in fusion_flops.k1_launches(cell.config, 64)] == [
        (1900, 64, 500), (1900, 64, 500), (1900, 64, 300), (1900, 64, 300), (1900, 64, 100)]


def test_the_k1_roofline_at_mixed_widths():
    """Three K1 launches in the canned window, one call of three shapes; at
    these sizes every bound is the bytes': xp and U read, hs written, both
    directions."""
    T, B = 10, 2
    record = {"calls": [(0.0, 1.0, B)],
              "k1_launches": [{"T": T, "B": B, "H": H} for H in (4, 3, 2)]}
    nbytes = sum(2 * (T * B * 4 * H * 2 + H * 4 * H * 2 + T * B * H * 2) for H in (4, 3, 2))
    read = harness.load_module("metrics", "k1_roofline.fusion_decode").read
    assert math.isclose(read(record, EVENTS), 100.0 * nbytes / 3.35e12 * 1e6 / (200 + 60 + 30))
    assert read({"calls": record["calls"]}, EVENTS) is None  # a one-encoder record
    assert read(record, None) is None
    assert read(record, [e for e in EVENTS if e["name"] != "lstm_fwd_kernel"]) is None


def test_the_reference_imports_neither_jax_nor_the_port():
    path = Path(ROOT) / "benchmark" / "reference" / "late_fusion.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names & {"jax", "jaxlib", "flax", "mgr_tpu", "mgr_tpu_torch"} == set()
    assert "benchmark" in names and "torch" in names


@pytest.mark.cuda
def test_control_fails_at_full_size(cuda_device):
    cell = harness.load_cell(FUSION)
    r = harness.run(cell, 2**31 + 6, 3.0, False, cuda_device, time.perf_counter(),
                    substitute="control")
    assert not r["correct"], r["checks"]
