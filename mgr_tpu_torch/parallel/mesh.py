"""The (data, model, time) mesh of ranks (``mgr_tpu/parallel/mesh.py``).

JAX lays devices out as a ``Mesh``; here each process is one rank of a
``torch.distributed`` group and the mesh is the layout of ranks, in the
order JAX's ``make_mesh`` reshapes its devices (data, model, time,
row-major): rank ``r = (d * model + m) * time + t``. Each rank holds the
group of each axis through it: its data group (the ranks with its model
and time indices, over which the batch rows split), its model group (the
ranks with its data and time indices, which split the BLSTM directions
when model = 2 and time = 1, else the LSTM's hidden units) and its time
group (the ranks with its data and model indices, which split the time
axis of the inputs and projections).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from mgr_tpu_torch.core.config import MeshConfig
from mgr_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    config: MeshConfig
    rank: int
    device: torch.device
    data_group: Any   # torch.distributed.ProcessGroup of this rank's data axis
    model_group: Any  # ... of this rank's model axis
    time_group: Any   # ... of this rank's time axis

    @property
    def data(self) -> int:
        return self.config.data

    @property
    def model(self) -> int:
        return self.config.model

    @property
    def time(self) -> int:
        return self.config.time

    @property
    def size(self) -> int:
        return self.config.num_devices

    @property
    def data_index(self) -> int:
        return self.rank // (self.config.model * self.config.time)

    @property
    def model_index(self) -> int:
        return self.rank // self.config.time % self.config.model

    @property
    def time_index(self) -> int:
        return self.rank % self.config.time

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(cfg: MeshConfig, device: Optional[torch.device | str] = None) -> Mesh:
    """This rank's place in a ``cfg.data x cfg.model x cfg.time`` mesh
    over the initialized process group, whose size must be
    ``data * model * time``.

    ``device`` is where this rank's model and batches live: by default
    ``cuda:LOCAL_RANK`` (one card per rank), else the device named (the
    CPU, or one card that several ranks share). Every rank must call this
    (it creates the groups, a collective call)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: launch with "
            "torchrun and call mgr_tpu_torch.parallel.multihost.initialize()")
    world = dist.get_world_size()
    D, M, T = cfg.data, cfg.model, cfg.time
    if world != cfg.num_devices:
        raise ValueError(f"mesh {D}x{M}x{T} needs {cfg.num_devices} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()

    def at(d: int, m: int, t: int) -> int:
        return (d * M + m) * T + t

    # new_group is collective: every rank creates every group, in one order.
    timeout = datetime.timedelta(seconds=multihost.TIMEOUT_S)
    d, m, t = rank // (M * T), rank // T % M, rank % T
    data_groups = {(mm, tt): dist.new_group([at(j, mm, tt) for j in range(D)], timeout=timeout)
                   for mm in range(M) for tt in range(T)}
    model_groups = {(dd, tt): dist.new_group([at(dd, j, tt) for j in range(M)], timeout=timeout)
                    for dd in range(D) for tt in range(T)}
    time_groups = {(dd, mm): dist.new_group([at(dd, mm, j) for j in range(T)], timeout=timeout)
                   for dd in range(D) for mm in range(M)}
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(cfg, rank, device, data_groups[m, t], model_groups[d, t], time_groups[d, m])
