"""Ranks of a ``torch.distributed`` process group as a (data, model, time) mesh:
process start-up, the mesh and its groups, the batch split and the
collectives of the mesh train and eval steps (``mgr_tpu/parallel``)."""

from mgr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from mgr_tpu_torch.parallel.sharding import shard_batch  # noqa: F401
