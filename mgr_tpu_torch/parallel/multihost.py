"""Process start-up for multi-process runs (``mgr_tpu/parallel/multihost.py``).

A mesh run is launched by ``torchrun --nproc-per-node N``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each process; :func:`initialize` brings the process
group up from them. A run without ``WORLD_SIZE`` is a single process and
needs no group. Checkpoints are written by the primary rank only
(``train.loop.fit``).
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective that waits longer than this fails the run


def initialize(backend: str) -> bool:
    """Idempotent ``init_process_group`` from torchrun's environment
    (``env://``), with ``backend`` ("nccl" for one card per rank, "gloo"
    for CPU ranks or ranks sharing one card). A no-op when a group is
    already up or when ``WORLD_SIZE`` is unset (a single-process run).
    Returns whether a process group is up. Raises when ``backend`` is not
    built into this torch."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(
            f"torch.distributed backend {backend!r} is not available in this "
            f"torch build")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def is_primary() -> bool:
    """Rank 0 of the group, or a single process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def process_info() -> dict:
    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
        "backend": dist.get_backend() if up else None,
    }
