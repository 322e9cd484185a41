"""Wall-clock timing helper (``mgr_tpu/utils/timing.py``)."""

from __future__ import annotations

import time


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.seconds``.
    Host clock only: synchronize the device inside the block to time its
    work."""

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._start
