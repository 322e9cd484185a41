"""How batches and parameters map onto the mesh
(``mgr_tpu/parallel/sharding.py``), for the meshes the port serves: pure
data parallelism, and data parallelism x direction-sharded tensor
parallelism on a model axis of 2. Parameters stay replicated on every
rank, as ``param_pspecs`` has them on the shard_map path (``:96-97``);
the batch splits over the data axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from mgr_tpu_torch.core.config import MeshConfig

GSPMD_ITEM = "ROADMAP.md 'Modules to port', 'The GSPMD mesh path'"


def shardmap_axes(cfg: MeshConfig) -> Tuple[str, Optional[str]]:
    """``(data_axis, model_axis or None)`` for a mesh the port serves
    (``:43-59``): pure DP, or DP x a model axis of 2, where each rank runs
    one BLSTM direction. Raises on a model axis above 2 or a time axis:
    those need the JAX package's GSPMD path (the XLA-partitioned scan),
    which is not ported."""
    if cfg.model > 2 or cfg.time > 1:
        raise NotImplementedError(
            f"mesh {cfg.data}x{cfg.model}x{cfg.time}: a model axis above 2 or a "
            f"time axis needs the JAX package's GSPMD path, which is not ported "
            f"({GSPMD_ITEM}); use DATAx1 or DATAx2")
    return cfg.data_axis, (cfg.model_axis if cfg.model == 2 else None)


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: the ``mesh.data_index``-th of
    ``mesh.data`` contiguous blocks of the leading axis, as ``P(data)``
    places them. Works on numpy arrays and tensors."""
    out = {}
    for k, x in batch.items():
        n = x.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch axis {n} of {k!r} does not split over "
                             f"{mesh.data} data ranks")
        m = n // mesh.data
        out[k] = x[mesh.data_index * m:(mesh.data_index + 1) * m]
    return out
