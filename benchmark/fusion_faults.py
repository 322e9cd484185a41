"""A fault planted under the two-stream decode, and its readings.

``faults.py``'s ``half_batch`` slices one input tensor, so inside the
late-fusion decode step, which is handed the pair, it raises. ``half_pairs``
is its two-stream version: the first half of the rows of both streams
decoded, and those rows handed back for the rest.

    python3 benchmark/fusion_faults.py --workload late_fusion-decode-b64 \
        --fault half_pairs --fault-seeds 7,8,9 [--seconds 8]

runs ``calibrate.py`` with ``half_pairs`` among the faults it plants; every
argument is ``calibrate.py``'s.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import calibrate, faults  # noqa: E402


@contextlib.contextmanager
def half_pairs():
    from mgr_tpu_torch.decode import decoder as dec_mod

    make = dec_mod.make_decode_step

    def half_decode(model, **kw):
        step = make(model, **kw)

        def halved(inputs, lengths=None):
            n = inputs[0].shape[0]
            h = max(1, n // 2)
            best, emit = step(tuple(x[:h] for x in inputs),
                              None if lengths is None else lengths[:h])
            reps = -(-n // h)
            return best.repeat(reps, 1)[:n], emit.repeat(reps, 1)[:n]

        return halved

    dec_mod.make_decode_step = half_decode
    try:
        yield
    finally:
        dec_mod.make_decode_step = make


PLANTED = faults.planted


def planted(name: str):
    """``faults.planted``, and ``half_pairs`` by that name."""
    return half_pairs() if name == "half_pairs" else PLANTED(name)


def main(argv=None) -> int:
    faults.planted = planted  # calibrate.py looks it up at each run
    try:
        return calibrate.main(argv)
    finally:
        faults.planted = PLANTED


if __name__ == "__main__":
    sys.exit(main())
