"""How batches and parameters map onto the mesh
(``mgr_tpu/parallel/sharding.py``).

Two routes, as in the JAX package. A mesh of pure data parallelism, or
data parallelism x a model axis of 2, takes the shard_map route
(:func:`shardmap_axes`): parameters replicated, each rank of a model pair
runs one BLSTM direction. Every other mesh (a model axis above 2, or a
time axis) takes the GSPMD route: each rank of the model axis computes a
contiguous block of the LSTM's hidden units, all four gates of it
(:func:`param_pspecs`), and each rank of the time axis projects its slice
of the time steps. Parameters stay replicated in storage on every rank on
both routes; the batch splits over the data axis, and on the GSPMD route
its sequence leaves also over the time axis (:func:`shard_batch`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from mgr_tpu_torch.core.config import MeshConfig


def shardmap_axes(cfg: MeshConfig) -> Optional[Tuple[str, Optional[str]]]:
    """``(data_axis, model_axis or None)`` for a mesh of the shard_map
    route (``:43-59``): pure DP, or DP x a model axis of 2, where each rank
    runs one BLSTM direction. None for a mesh of the GSPMD route: a model
    axis other than 1 or 2, or a time axis above 1."""
    if cfg.time > 1 or cfg.model > 2:
        return None
    return cfg.data_axis, (cfg.model_axis if cfg.model == 2 else None)


def h_sharded(hidden: int, cfg: MeshConfig) -> bool:
    """Whether a BLSTM layer of ``hidden`` units computes an H-block a rank
    on ``cfg``: the GSPMD route, a model axis above 1, and ``hidden``
    divisible by it; else every rank of the model axis computes the whole
    layer, as JAX replicates a leaf whose H does not divide (``:105-108``)."""
    return shardmap_axes(cfg) is None and cfg.model > 1 and hidden % cfg.model == 0


def param_pspecs(params: Dict[str, Any], cfg: MeshConfig) -> Dict[str, Optional[str]]:
    """For each parameter (by ``state_dict`` name), the mesh axis whose
    ranks each compute a block of its trailing H axis, or None where
    every rank computes all of it (``:62-111``): the BLSTM leaves ``W``
    (D, F, 4, H) and ``U`` (D, H, 4, H) of rank 4 and ``b`` (D, 4, H) of
    rank 3, matched by name and rank, when :func:`h_sharded` holds for
    their H. Storage stays replicated; this is what each rank computes."""
    def axis(name: str, shape) -> Optional[str]:
        leaf = name.split(".")[-1]
        blstm = (leaf in ("W", "U") and len(shape) == 4) or (leaf == "b" and len(shape) == 3)
        return cfg.model_axis if blstm and h_sharded(shape[-1], cfg) else None

    return {k: axis(k, tuple(v.shape)) for k, v in params.items()}


def _block(x, axis: int, n: int, i: int, what: str):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} ({size}) of {what} does not split over {n} ranks")
    m = size // n
    index = [slice(None)] * x.ndim
    index[axis] = slice(i * m, (i + 1) * m)
    return x[tuple(index)]


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's part of a global batch: the ``mesh.data_index``-th of
    ``mesh.data`` contiguous blocks of the leading axis, as ``P(data)``
    places them, and on a time axis (``mesh.time`` above 1) of every leaf
    of rank 3 or more also the ``mesh.time_index``-th block of axis 1, as
    ``P(data, time)`` places them. Either axis must divide by its ranks,
    as JAX's ``device_put`` requires. Works on numpy arrays and tensors."""
    out = {}
    for k, x in batch.items():
        x = _block(x, 0, mesh.data, mesh.data_index, f"{k!r} (data ranks)")
        if mesh.time > 1 and x.ndim >= 3:
            x = _block(x, 1, mesh.time, mesh.time_index, f"{k!r} (time ranks)")
        out[k] = x
    return out
