"""Registry and run loop of the benchmark.

Everything that belongs to one cell, configuration, traffic kind or metric
sits in files of its own, found by the name ``BENCHMARK.json`` gives:

  BENCHMARK.json                    cells, configurations, metrics and bounds
  benchmark/configs/<config>.json   the pipeline configuration as it is run
  benchmark/workloads/<cell>.json   traffic kind, its parameters, the limits of ``correct``
  benchmark/traffic/<kind>.py       the generator and driver of one traffic kind
  benchmark/metrics/<metric>.py     the reader of one metric
  benchmark/reference/<name>.py     the plain reference a configuration names

A run: the driver's set-up (weights and inputs from the seed, warm-up),
then ``seconds`` of timed calls into the port, each inside a span named
by the entry it calls; then the readers turn the run's record (and, with
``trace``, the profiler's events) into metrics; then, with the program's
state freed, the driver compares what the timed path produced with the
plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mgr_tpu")
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything its files give."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]     # benchmark/configs/<config>.json
    traffic: str
    kind: str                  # benchmark/traffic/<kind>.py
    params: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, root: Path = ROOT, overrides: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json. ``overrides`` (tests
    only) is merged into the configuration file's ``pipeline`` and into the
    workload's ``params``."""
    spec = load_spec(root)
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choose from {[w['name'] for w in spec['workloads']]}")
    entry = entries[0]
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    work = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    if work["config"] != entry["config"] or work["traffic"] != entry["traffic"]:
        raise ValueError(f"benchmark/workloads/{name}.json disagrees with BENCHMARK.json")
    params = work["params"]
    if overrides:
        config = dict(config, pipeline=_merge(config["pipeline"], overrides.get("pipeline", {})))
        params = _merge(params, overrides.get("params", {}))
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"], config=config,
        traffic=entry["traffic"], kind=work["kind"], params=params, limits=work["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_module(folder: str, name: str, root: Path = ROOT):
    """``benchmark/<folder>/<name>.py``, loaded from its file (a metric's
    name may hold dots)."""
    path = root / "benchmark" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names among ``modules`` (default ``sys.modules``) that
    are JAX or the JAX package, compared whole: ``mgr_tpu_torch`` passes."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sub_seed(seed: int, *names: Any) -> int:
    """A 63-bit seed for the stream ``names`` of the run seeded ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(names)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, *names: Any, device="cpu"):
    import torch

    return torch.Generator(device=device).manual_seed(sub_seed(seed, *names))


# ---------------------------------------------------------------------------
# Weights: made by the benchmark on the device from the seed, in a few large
# draws, and handed alike to the port and to the reference.
# ---------------------------------------------------------------------------

KERNEL_SCALE = 0.05


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 scales: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """f32 weights for parameters named and shaped as the port's models
    name them, distributed as the reference repository initialises them:
    kernels (``*.W``, ``cnn.conv_*``) uniform in +-0.05 (times
    ``scales[name]`` for a kernel named there); recurrent kernels
    (``*.U``, (2, H, 4, H)) orthogonal (H, 4H) per direction; LSTM biases
    (``*.b`` of shape (2, 4, H)) zero with a unit forget gate; other
    biases zero. One uniform draw for every kernel, one normal draw and
    one batched QR per hidden size for the recurrent kernels."""
    import torch

    out: Dict[str, Any] = {}
    uniform = [k for k, s in shapes.items() if k.endswith(".W") or ".conv_" in k]
    total = sum(math.prod(shapes[k]) for k in uniform)
    flat = (torch.rand(total, generator=generator(seed, "kernels", device=device),
                       device=device) * 2.0 - 1.0) * KERNEL_SCALE
    at = 0
    for k in uniform:
        n = math.prod(shapes[k])
        out[k] = flat[at:at + n].reshape(shapes[k]) * (scales or {}).get(k, 1.0)
        at += n
    recurrent = [k for k in shapes if k.endswith(".U")]
    for H in sorted({shapes[k][1] for k in recurrent}):
        keys = [k for k in recurrent if shapes[k][1] == H]
        a = torch.randn((2 * len(keys), 4 * H, H), device=device,
                        generator=generator(seed, "recurrent", H, device=device))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        u = q.transpose(1, 2).reshape(len(keys), 2, H, 4, H)
        for i, k in enumerate(keys):
            out[k] = u[i].contiguous()
    for k, s in shapes.items():
        if k in out:
            continue
        b = torch.zeros(s, device=device)
        if len(s) == 3 and s[1] == 4 and k.endswith(".b"):
            b[:, 1] = 1.0
        out[k] = b
    return out


def load_weights(model, weights: Dict[str, Any]) -> None:
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


def pipeline_config(cell: Cell, **replace):
    """The port's PipelineConfig of the cell's configuration file."""
    from mgr_tpu_torch.core.config import PipelineConfig

    cfg = PipelineConfig.from_json(json.dumps(cell.config["pipeline"]))
    return cfg.replace(**replace) if replace else cfg


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Marks:
    """Seconds of each named stage of a driver's set-up, synchronised."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


@dataclasses.dataclass
class Run:
    """What a traffic driver is given: its cell, seed and device."""

    cell: Cell
    seed: int
    device: Any
    root: Path = ROOT

    def reference(self):
        return load_module("reference", self.cell.config["reference"], self.root)


def _device_info(device) -> Dict[str, Any]:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(trace: bool, device):
    """torch.profiler over the window (CPU and CUDA activities), its events
    handed back as the chrome trace's list; nothing without ``trace``."""
    box: Dict[str, Any] = {"events": None}
    if not trace:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield box
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["events"] = json.load(f)["traceEvents"]


def read_metrics(cell: Cell, record: Dict[str, Any], events, section: str,
                 root: Path = ROOT) -> Dict[str, Dict[str, Any]]:
    """Each of the cell's ``section`` metrics from its reader; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in (cell.end_to_end if section == "end_to_end" else cell.per_layer):
        value = load_module("metrics", m["name"], root).read(record, events)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: List[Dict[str, Any]]) -> bool:
    """Every number that has a limit at or under it (a NaN fails)."""
    return all(c["value"] <= c["limit"] for c in checks if c["limit"] is not None)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        substitute: Optional[str] = None, root: Path = ROOT) -> Dict[str, Any]:
    """One run of ``cell``: set-up, the window, the metrics and the check.
    ``substitute="control"`` (calibration only) judges the reference in a
    lower precision in the program's place. Returns the result line's
    object, ``checks`` last."""
    import torch
    from torch.profiler import record_function

    from mgr_tpu_torch.ops import dispatch

    drv = load_module("traffic", cell.kind, root).Driver(Run(cell, seed, device, root))
    drv.setup()
    _synchronize(device)
    setup_s = time.perf_counter() - t_start
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dispatch.reset_launch_counts()
    calls: List[tuple] = []
    with _profiled(trace, device) as box:
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                ts = time.perf_counter()
                with record_function(drv.span):
                    items = drv.call()
                calls.append((ts - t0, time.perf_counter() - t0, items))
            _synchronize(device)
            window_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    info = _device_info(device)
    record = dict(drv.record(), setup_s=setup_s, window_s=window_s, calls=calls,
                  items=sum(c[2] for c in calls), memory_peak_bytes=info["memory_peak_bytes"])
    events = box.pop("events")
    metrics = read_metrics(cell, record, events, "per_layer" if trace else "end_to_end", root)
    breakdown = None
    if trace:
        from benchmark import trace as trace_lib

        busy, span = trace_lib.busy_and_window_us(events)
        info["busy_s"], info["window_s"] = busy / 1e6, span / 1e6
        breakdown = trace_lib.breakdown(events)
    del events
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    checks, failed = drv.check(substitute)
    result = {"correct": judge(checks) and failed == 0, "attempted": record["items"],
              "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    uncompared = {c["name"]: c["value"] for c in checks if c["limit"] is None}
    result["summary"] = dict(summary(record, launches), uncompared=uncompared,
                             worst_leaf={c["name"]: c["at"] for c in checks if "at" in c})
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks if c["limit"] is not None}
    return result


def _percentiles(values: List[float]) -> Dict[str, float]:
    if len(values) < 2:
        return {}
    q = statistics.quantiles(values, n=20, method="inclusive")
    return {"p5": q[0], "p50": statistics.median(values), "p95": q[-1], "max": max(values)}


def summary(record: Dict[str, Any], launches: Dict[str, int]) -> Dict[str, Any]:
    """What the metrics rest on: the window's calls and items, the requests
    beyond the 95th percentile, and the port's kernel launches a call
    (``ops.dispatch`` counters; not a metric)."""
    n = len(record["calls"])
    return {"calls": n, "items": record["items"], "window_s": record["window_s"],
            "beyond_p95": n - max(0, math.ceil(0.95 * n)) if n else 0,
            "setup_marks": record.get("setup_marks", {}),
            "call_ms": _percentiles([1e3 * (b - a) for a, b, _ in record["calls"]]),
            "launches_per_call": {k: v / n for k, v in launches.items() if v} if n else {}}


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the process that measures."""

    def __init__(self, names: List[str]):
        super().__init__(f"sys.modules holds {names} after the window")
        self.names = names
