"""Readings that the limits of ``correct`` are set from, on the card, in
one process: the program's numbers over many seeds (the lower readings),
the control's (the reference in a lower precision put in the program's
place) and each planted fault's (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9] [--seconds 3]

One JSON line a run: what ran (program, control or fault), its seed,
``correct`` against the limits in force, and every number compared.
The benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    plan = [("program", s, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None) for s in _seeds(args.control_seeds)]
    plan += [(f"fault:{f}", s, f) for f in args.fault for s in _seeds(args.fault_seeds)]
    for what, seed, fault in plan:
        t0 = time.perf_counter()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            r = harness.run(cell, seed, args.seconds, False, dev, t0,
                            substitute="control" if what == "control" else None)
        print(json.dumps({"workload": cell.name, "what": what, "seed": seed,
                          "correct": r["correct"], "failed": r["failed"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
