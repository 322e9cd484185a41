"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without enough CUDA cards, without the port, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    except harness.ForbiddenImport as err:
        print(f"forbidden modules loaded: {err.names}: no result", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
