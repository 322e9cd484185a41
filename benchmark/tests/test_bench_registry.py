"""The harness finds every cell's files by name, BENCHMARK.json keeps to
its contract, and a cell, a configuration and a metric are added by new
files and entries alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from conftest import ROOT, tiny

SPEC = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keep_to_the_contract():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (Path(ROOT) / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert harness.load_module("traffic", c.kind).Driver
    assert harness.load_module("reference", c.config["reference"]).Reference
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # each per-layer metric moves a metric its cells report
        assert m["moves"] in e2e
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_layers_are_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert all("\n" not in layer and len(layer) <= 200 for layer in by_layer)


def test_a_cell_config_and_metric_are_added_by_new_files(tmp_path):
    """A copy of the checkout's benchmark gains a configuration, a cell and
    a per-layer metric by new files and new entries only, and runs."""
    shutil.copytree(Path(ROOT) / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    config = json.loads((Path(ROOT) / "benchmark/configs/speech.json").read_text())
    config["pipeline"]["encoder"]["hidden"] = 6
    (tmp_path / "benchmark/configs/dummy.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "dummy", "source": "a test", "file":
                            "benchmark/configs/dummy.json", "reduced": [], "why": "a test"})
    work = json.loads((Path(ROOT) / "benchmark/workloads/speech-infer-b1.json").read_text())
    work.update(config="dummy", traffic="dummy-mix")
    (tmp_path / "benchmark/workloads/dummy-cell.json").write_text(json.dumps(work))
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                              "chips": 1, "why": "a test"})
    (tmp_path / "benchmark/metrics/calls.dummy.py").write_text(
        "def read(record, events):\n    return float(len(record['calls']))\n")
    spec["per_layer"].append({"name": "calls.dummy", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "a test",
                              "moves": "infer_p95_ms", "workloads": ["dummy-cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "infer_p95_ms":
            m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    overrides = tiny("speech-infer-b1")
    overrides["pipeline"]["encoder"].pop("hidden")
    cell = harness.load_cell("dummy-cell", root=tmp_path, overrides=overrides)
    assert cell.config["pipeline"]["encoder"]["hidden"] == 6
    r = harness.run(cell, 5, 0.3, True, torch.device("cpu"), time.perf_counter(), root=tmp_path)
    assert r["correct"] and r["metrics"]["calls.dummy"]["value"] >= 1
    assert list(r)[-1] == "checks"
