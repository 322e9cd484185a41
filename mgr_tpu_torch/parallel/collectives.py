"""Collectives over a process group (``mgr_tpu/parallel/collectives.py``).

The mesh steps' collectives are ``psum``, ``pmean``, ``pmean_tree``,
``broadcast_``, ``any_rank``, the block exchanges (``gather_blocks`` and
its transpose ``psum_block``: the direction exchange
``gather_directions``, the GSPMD route's time gather ``gather_time`` and
its per-step exchange of the LSTM's hidden units) and the decode step's
``all_gather_rows``. The block exchanges are written with ``all_reduce``
alone: gloo, the one backend under which several ranks can share one card
(NCCL refuses two ranks on one device), has no CUDA ``all_gather`` or
``reduce_scatter``, and an all-reduce of a buffer whose other blocks are
zero is exact on every backend. ``all_gather_rows`` uses the group's own
``all_gather`` where the backend serves the tensor's device (NCCL on
CUDA, gloo on CPU) and goes through the host for gloo and a CUDA tensor.
The generic ``all_gather``, ``ppermute_ring`` and ``reduce_scatter`` use
the group's own collectives: over gloo they take CPU tensors, over NCCL
CUDA tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist


def psum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a new tensor)."""
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def pmean(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Mean of ``x`` over ``group``: the sum, then divided by the group's
    size, as ``jax.lax.pmean``."""
    return psum(x, group) / dist.get_world_size(group)


def pmean_tree(tree: Dict[str, torch.Tensor], group: Any) -> Dict[str, torch.Tensor]:
    """:func:`pmean` of every tensor of a dict (one dtype), as ONE
    all-reduce of their concatenation, so a step pays one collective's
    latency."""
    if len({v.dtype for v in tree.values()}) != 1:
        raise ValueError("pmean_tree needs tensors of one dtype")
    if dist.get_world_size(group) == 1:
        return dict(tree)
    flat = pmean(torch.cat([v.detach().reshape(-1) for v in tree.values()]), group)
    out, at = {}, 0
    for k, v in tree.items():
        out[k] = flat[at:at + v.numel()].view_as(v)
        at += v.numel()
    return out


def broadcast_(tensors) -> None:
    """Overwrite every tensor, in place, with rank 0's (over all ranks)."""
    for t in tensors:
        dist.broadcast(t, src=0)


def _served(x: torch.Tensor, group: Any) -> bool:
    """Whether the group's backend gathers and scatters tensors on
    ``x``'s device: NCCL on CUDA, gloo on the CPU."""
    return (dist.get_backend(group) == dist.Backend.NCCL) == x.is_cuda


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of the process group (one
    all-reduce of a flag on ``device``, which the backend must serve)."""
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _block_index(ndim: int, axis: int, index: int, size: int):
    at = [slice(None)] * ndim
    at[axis] = slice(index * size, (index + 1) * size)
    return tuple(at)


def psum_block(g: torch.Tensor, group: Any, index: int, axis: int) -> torch.Tensor:
    """The transpose of :func:`gather_blocks` (JAX's ``psum_scatter`` of
    an ``all_gather``): ``g`` summed over the group by one all-reduce,
    then this rank's ``index``-th of the group's equal blocks along
    ``axis``."""
    n = dist.get_world_size(group)
    g = g.contiguous().clone()
    dist.all_reduce(g, group=group)
    return g[_block_index(g.ndim, axis, index, g.shape[axis] // n)]


class _GatherBlocks(torch.autograd.Function):
    """Forward: every rank's block concatenated along ``axis`` in group
    rank order, as an all-reduce of a buffer whose other blocks are zero
    (exact: x + 0 = x). Backward: :func:`psum_block`."""

    @staticmethod
    def forward(ctx, x, group, index, axis):
        ctx.group, ctx.index, ctx.axis = group, index, axis
        n = dist.get_world_size(group)
        shape = list(x.shape)
        shape[axis] *= n
        buf = x.new_zeros(shape)
        buf[_block_index(x.ndim, axis, index, x.shape[axis])] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return psum_block(g, ctx.group, ctx.index, ctx.axis), None, None, None


def gather_blocks(x: torch.Tensor, group: Any, index: int, axis: int) -> torch.Tensor:
    """This rank's block ``x``, the ``index``-th of the group's equal
    blocks along ``axis``, -> the whole tensor, every block in group rank
    order, in ``x``'s dtype (``jax.lax.all_gather`` with ``tiled=True``);
    differentiable, its backward :func:`psum_block`."""
    return _GatherBlocks.apply(x, group, index, axis)


def gather_directions(h: torch.Tensor, group: Any, direction: int) -> torch.Tensor:
    """``(T, B, H)`` stream of this rank's direction -> ``(2, T, B, H)``
    streams of both directions, in ``h``'s dtype, over the model group of
    two ranks (``jax.lax.all_gather`` in ``bilstm_layer_tm_dirsharded``);
    differentiable: the backward sums the cotangent over the group, then
    takes this rank's slot."""
    if dist.get_world_size(group) != 2:
        raise ValueError("the direction exchange needs a model group of 2 ranks")
    return gather_blocks(h.unsqueeze(0), group, direction, 0)


def gather_time(x: torch.Tensor, group: Any, index: int) -> torch.Tensor:
    """``(T / n, ...)`` time-major slice of this rank, the ``index``-th of
    the time group's ``n`` -> the whole ``(T, ...)``, on every rank of the
    group: the all-gather of T that XLA inserts before the serial
    recurrence on a time axis; differentiable."""
    return gather_blocks(x, group, index, 0)


def all_gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in group rank order,
    on ``x``'s device; through the host where the backend cannot gather
    on that device (gloo and a CUDA tensor)."""
    if _served(x, group):
        return all_gather(x, group)
    return all_gather(x.cpu(), group).to(x.device)


def all_gather(x: torch.Tensor, group: Any = None, *, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along axis 0
    (``tiled``) or stacked on a new leading axis, as
    ``jax.lax.all_gather``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out if tiled else out.reshape((n,) + tuple(x.shape))


def ppermute_ring(x: torch.Tensor, group: Any = None, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` sent to rank (i + shift) mod n; returns what this
    rank received, from rank (i - shift) mod n (``jax.lax.ppermute`` over
    the ring)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if shift % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    g = group or dist.group.WORLD
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(g, (i + shift) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(g, (i - shift) % n), group),
    ])
    for req in reqs:
        req.wait()
    return out


def reduce_scatter(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of ``x`` over the group, split along axis 0 into one block
    per rank; returns this rank's block (``jax.lax.psum_scatter``,
    ``tiled=True``). Axis 0 must divide by the group's size."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: axis 0 ({x.shape[0]}) does not divide by {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out
