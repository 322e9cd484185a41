"""Structured per-step/per-epoch metrics (``mgr_tpu/core/metrics.py``).

The reference's only observability was print statements and Keras's
loss/val_loss progress bars (SURVEY.md §5.5). This logger emits JSONL
records (machine-readable, one file per run) plus human lines, and
tracks the framework's north-star metric: sequences/sec/chip.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, workdir: Optional[str] = None, stamp: str = "run", stream=None,
                 num_chips: int = 1):
        self.stream = stream if stream is not None else sys.stderr
        self.num_chips = max(int(num_chips), 1)
        self._f = None
        if workdir is not None:
            os.makedirs(workdir, exist_ok=True)
            self._f = open(os.path.join(workdir, f"{stamp}_metrics.jsonl"), "a")
        self._epoch_start = None
        self._epoch_seqs = 0

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def start_epoch(self, epoch: int) -> None:
        self._epoch_start = time.time()
        self._epoch_seqs = 0
        self._epoch = epoch

    def note_epoch(self, epoch: int) -> None:
        """Advance the epoch label without resetting the wall clock or the
        sequence count: under fit(sync_every>1) one record covers a window
        of epochs."""
        self._epoch = epoch

    def step(self, loss: float, batch_size: int, **extra: Any) -> None:
        """One step's record (``{"kind": "step", "loss": ...}``), its
        sequences counted toward the epoch's throughput."""
        self._epoch_seqs += batch_size
        self.log({"kind": "step", "loss": float(loss), **extra})

    def add_seqs(self, n: int) -> None:
        """Count sequences without a per-step record (the fit loop keeps
        losses on device and logs once per epoch)."""
        self._epoch_seqs += n

    def end_epoch(
        self, train_loss: float, val_loss: Optional[float] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        wall = time.time() - (self._epoch_start or time.time())
        seqs_per_sec = self._epoch_seqs / wall if wall > 0 else 0.0
        rec = {
            "kind": "epoch",
            "epoch": getattr(self, "_epoch", -1),
            "train_loss": float(train_loss),
            "val_loss": None if val_loss is None else float(val_loss),
            "wall_s": wall,
            "seqs_per_sec": seqs_per_sec,
            "seqs_per_sec_per_chip": seqs_per_sec / self.num_chips,
            **extra,
        }
        self.log(rec)
        vl = "" if val_loss is None else f" val_loss={val_loss:.4f}"
        print(
            f"[epoch {rec['epoch']}] loss={train_loss:.4f}{vl} "
            f"({seqs_per_sec:.2f} seq/s, {wall:.1f}s)",
            file=self.stream,
        )
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
