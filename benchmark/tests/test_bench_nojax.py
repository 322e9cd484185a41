"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), the reference imports no module of the port, and a
run without a card prints no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness
from conftest import ROOT

BENCH = Path(ROOT) / "benchmark"


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["mgr_tpu_torch", "mgr_tpu_torch.ops", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["mgr_tpu.ops.lstm", "jax", "jaxlib.xla", "flax.linen",
                                      "mgr_tpu_torch"]) == ["flax", "jax", "jaxlib", "mgr_tpu"]


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_jax_nor_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        found = _imports(path) & {"jax", "jaxlib", "flax", "mgr_tpu", "mgr_tpu_torch"}
        assert not found, (path.name, found)


def test_no_benchmark_file_imports_jax():
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "mgr_tpu"}, path


def test_a_whole_run_loads_no_jax():
    """Every module of the harness, a run of each traffic kind on the CPU,
    its traced run and its check, in a fresh process."""
    code = """
import json, sys, time
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import torch
from benchmark import harness, calibrate, faults, roofline, readers, trace
from conftest import tiny
for name in ("speech-train-b128", "speech-decode-b128"):
    cell = harness.load_cell(name, overrides=tiny(name))
    harness.run(cell, 3, 0.2, True, torch.device("cpu"), time.perf_counter())
for folder in ("metrics", "traffic", "reference"):
    for p in sorted((harness.BENCH / folder).glob("*.py")):
        if p.stem != "__init__":
            harness.load_module(folder, p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""" % (ROOT, str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness.forbidden_modules(loaded) == []
    assert "mgr_tpu_torch" in loaded


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "speech-infer-b1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
