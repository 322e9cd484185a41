"""The (data, model) mesh of ranks (``mgr_tpu/parallel/mesh.py``).

JAX lays devices out as a ``Mesh``; here each process is one rank of a
``torch.distributed`` group and the mesh is the layout of ranks: rank r
has data index ``r // model`` and model index ``r % model``. Each rank
holds the group of its data axis (the ranks with its model index, over
which gradients are averaged) and of its model axis (the ranks with its
data index, which split the BLSTM directions when model = 2). A time axis
is not ported (ROADMAP.md, the GSPMD path).
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
from mgr_tpu_torch.parallel.sharding import GSPMD_ITEM


@dataclasses.dataclass(frozen=True)
class Mesh:
    config: MeshConfig
    rank: int
    device: torch.device
    data_group: Any   # torch.distributed.ProcessGroup of this rank's data axis
    model_group: Any  # ... of this rank's model axis

    @property
    def data(self) -> int:
        return self.config.data

    @property
    def model(self) -> int:
        return self.config.model

    @property
    def size(self) -> int:
        return self.config.data * self.config.model

    @property
    def data_index(self) -> int:
        return self.rank // self.config.model

    @property
    def model_index(self) -> int:
        return self.rank % self.config.model

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(cfg: MeshConfig, device: Optional[torch.device | str] = None) -> Mesh:
    """This rank's place in a ``cfg.data x cfg.model`` mesh over the
    initialized process group, whose size must be ``data * model``.

    ``device`` is where this rank's model and batches live: by default
    ``cuda:LOCAL_RANK`` (one card per rank), else the device named (the
    CPU, or one card that several ranks share). Every rank must call this
    (it creates the groups, a collective call)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: launch with "
            "torchrun and call mgr_tpu_torch.parallel.multihost.initialize()")
    if cfg.time > 1:
        raise NotImplementedError(
            f"mesh {cfg.data}x{cfg.model}x{cfg.time}: a time axis needs the JAX "
            f"package's GSPMD path, which is not ported ({GSPMD_ITEM})")
    world = dist.get_world_size()
    want = cfg.data * cfg.model
    if world != want:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {want} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    # new_group is collective: every rank creates every group, in one order.
    timeout = datetime.timedelta(seconds=multihost.TIMEOUT_S)
    data_groups = [dist.new_group([j * cfg.model + m for j in range(cfg.data)],
                                  timeout=timeout) for m in range(cfg.model)]
    model_groups = [dist.new_group([d * cfg.model + j for j in range(cfg.model)],
                                   timeout=timeout) for d in range(cfg.data)]
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(cfg, rank, device, data_groups[rank % cfg.model],
                model_groups[rank // cfg.model])
