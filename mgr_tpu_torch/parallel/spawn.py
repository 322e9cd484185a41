"""Run ranks of a process group on this host without torchrun: spawned
processes that reach each other over ``tcp://localhost``, with a time
limit on the whole run. ``chip_smoke.py`` uses it to run mesh steps with
ranks that share one card, and the CPU tests to run gloo meshes.

A rank that raises fails the run with its traceback; a run that outlives
its time limit has every rank killed and fails. No rank is left behind.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, timeout_s, results, args):
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        # Pickled by value: a tensor put on a queue as it is would be shared
        # through a handle that dies with this process.
        out = pickle.dumps(fn(rank, world, *args))
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, args: Sequence[Any] = (), *,
              timeout_s: float = 600.0) -> List[Any]:
    """Start ``world`` spawned processes; rank r calls
    ``fn(r, world, *args)`` inside an initialized gloo process group (the
    backend under which ranks may share one card) and returns a picklable
    result (tensors travel by value). Returns the results by
    rank. ``fn`` must be importable by module path (a module-level
    function). Raises if a rank fails or the run takes longer than
    ``timeout_s`` seconds, after killing every rank still running."""
    if not dist.is_available() or not dist.is_backend_available("gloo"):
        raise RuntimeError("torch.distributed backend 'gloo' is not available")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, timeout_s, results, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failures = {}, []
    try:
        # Drain the queue before joining: a child blocks on exit until its
        # result is read.
        while len(got) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(got) + len(failures) < world:
                    # A rank died without reporting (killed, or crashed in C).
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(
                            f"rank(s) of {fn.__name__} exited with "
                            f"{[p.exitcode for p in procs]} without a result")
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                failures.append((rank, out))
                break  # the others may wait on the failed rank forever
        if failures:
            rank, tb = failures[0]
            raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{tb}")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
