"""Train, eval, predict and decode steps (``mgr_tpu/train/step.py``), on
one device, and the train, eval and decode steps over a mesh of ranks
(``make_train_step(model, mesh=)``, ``make_eval_step(model, mesh=)``,
``make_decode_step(model, ..., mesh=)``), for every family, on both of the
JAX package's routes (``parallel.sharding``): the shard_map route (pure
data parallelism, or data parallelism x direction-sharded tensor
parallelism on a model axis of 2) and the GSPMD route (a model axis above
2, where each rank computes a block of the LSTMs' hidden units, or a time
axis, where each rank projects a slice of the time steps; decoding there
is the one-process step, as in JAX).

JAX's steps take ``(params, ...)``; here the parameters live in the
module. The eval, predict and decode steps take the batch alone and run
under ``torch.inference_mode()``. The train step takes a
:class:`TrainState` whose ``params`` are the model's own parameters,
updated in place (one copy of the weights on the card, where JAX makes a
new tree each step). Inputs may be numpy arrays or tensors; they are
moved to the model's device.

Batch contract (as in the JAX package): ``inputs`` (B, T, F) (rgb: the
(B, T, D, D, 1) video), and for
the fusion families the second stream ``inputs2`` (B, T, F2) (the model
then takes the pair), ``labels`` (B, N) int -1 padded, ``input_length``
(B,) valid frames AFTER the CTC trim, ``label_length`` (B,). A mesh step
splits every one of them, the second stream too, by rows over the data
axis (JAX's ``in_specs`` ``P(data)`` over every leaf of the batch), and on
a time axis the sequence leaves also by time (``shard_batch``).

The indexed steps (``make_indexed_train_step``, ``make_indexed_eval_step``,
``mgr_tpu/train/step.py:290-321``) take the whole corpus as tensors on the
model's device (``Batcher.device_arrays``, uploaded once) and a (B,) row
index, gather the batch on the device and run the same step; only the
batch's origin differs. Under ``core.tracing.debug_nans`` every step
raises ``FloatingPointError`` on a loss or gradient norm that is not
finite; over a mesh every rank reaches that verdict at the same step
(a rank-local verdict is shared by a flag all-reduce first).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mgr_tpu_torch.core import prng, tracing
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops.ctc import ctc_loss_from_logits
from mgr_tpu_torch.ops.decoding import best_path_decode
from mgr_tpu_torch.parallel import collectives
from mgr_tpu_torch.parallel import sharding as shard_lib
from mgr_tpu_torch.train import optimizer as opt_lib


BATCH_KEYS = ("inputs", "labels", "input_length", "label_length")


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(x: Any, device: torch.device) -> Any:
    """An array or tensor, or a tuple of them (a fusion model's two
    streams), on ``device``."""
    if isinstance(x, tuple):
        return tuple(to_device(a, device) for a in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _keys(batch: Dict[str, Any]) -> Tuple[str, ...]:
    return BATCH_KEYS + (("inputs2",) if "inputs2" in batch else ())


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's ``BATCH_KEYS`` and, when present, ``inputs2`` on
    ``device``."""
    return {k: to_device(batch[k], device) for k in _keys(batch)}


def _rank_rows(batch: Dict[str, Any], mesh, device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, every key of
    :func:`batch_to_device` (the second stream too), sliced where the
    batch lies (on the host for host batches) and then moved to
    ``device``: a rank copies only its rows."""
    return batch_to_device(shard_lib.shard_batch({k: batch[k] for k in _keys(batch)}, mesh),
                           device)


def gather_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows ``idx`` of every corpus tensor, gathered where they lie."""
    return {k: v.index_select(0, idx) for k, v in arrays.items()}


def batch_inputs(batch: Dict[str, Any]) -> Any:
    """What the model takes: ``inputs``, or the pair (``inputs``,
    ``inputs2``) (``_batch_inputs``, ``mgr_tpu/train/step.py:52-55``)."""
    if "inputs2" in batch:
        return (batch["inputs"], batch["inputs2"])
    return batch["inputs"]


def _loss_from_batch(model: nn.Module, batch: Dict[str, torch.Tensor], *,
                     train: bool, rng: Optional[prng.Key]) -> torch.Tensor:
    """Mean CTC loss on the time-major path: (T, B, C) logits go straight
    to the CTC kernel (``mgr_tpu/train/step.py:58-80``)."""
    logits = model.apply_tm(batch_inputs(batch), train=train, rng=rng)
    losses = ctc_loss_from_logits(
        logits, batch["labels"], batch["input_length"], batch["label_length"],
        trim_frames=model.config.ctc.trim_frames, time_major=True,
    )
    loss = losses.mean()
    tracing.check_finite(loss, "loss")
    return loss


def _shard_context(mesh):
    """This rank's context on its mesh's route: the H-shard context on the
    GSPMD route, the direction-shard context on a model axis of 2, else a
    context that sets nothing (pure DP)."""
    axes = shard_lib.shardmap_axes(mesh.config)
    if axes is None:
        return dispatch.h_shard(dispatch.HShard(
            mesh.config, mesh.data_index, mesh.model_group, mesh.model_index,
            mesh.time_group, mesh.time_index))
    if axes[1] is None:
        return contextlib.nullcontext()
    return dispatch.direction_shard(mesh.model_group, mesh.model_index)


def _warn_gspmd(mesh) -> None:
    """Once per mesh shape, a warning of what the GSPMD route runs
    (``_warn_gspmd_fallback``, ``mgr_tpu/train/step.py:233-256``)."""
    shape = (mesh.data, mesh.model, mesh.time)
    if shape in _warned_mesh_shapes:
        return
    _warned_mesh_shapes.append(shape)
    logging.warning(
        "mesh %dx%dx%d: no shard_map mapping (model axis != 2 or time axis > 1): the "
        "GSPMD route runs an H-sharded recurrence where the model axis divides H, a "
        "per-step loop with one exchange of h over the model axis a time step and no "
        "K1/K2 kernel, and projects a slice of the time steps per time rank; use "
        "model=2 (direction-sharded, K5a/K5b) or pure DP (K1/K2) for the kernel path",
        *shape)


_warned_mesh_shapes: list = []


def _on_every_rank(mesh, fn: Callable[[], Any]) -> Any:
    """``fn()``, this rank's part of a mesh step. Under
    ``tracing.debug_nans`` its verdict (a non-finite local loss, or on a
    mesh without a model or time axis anomaly mode's error in its
    backward) does not stop this rank alone, which would leave the others
    waiting at their next collective: every rank first learns from one
    flag all-reduce whether any rank failed, then all raise
    ``FloatingPointError`` together. Any other error propagates as it is.

    With a model or time axis the backward holds the collectives of those
    axes (the exchanges' transposes), so a rank that raised inside it
    would leave its partners waiting there: anomaly mode's NaN check is
    off in ``fn``, a NaN of one rank's backward runs on through the
    exchanges into the combined gradients, and the check of their norm
    raises on every rank at once. The ranks of a data index compute the
    same loss from the same rows, so its check fails on all of them or on
    none, before the backward."""
    if not tracing.debugging_nans():
        return fn()
    failed = None
    with torch.autograd.set_detect_anomaly(True, check_nan=mesh.model == 1 and mesh.time == 1):
        try:
            out = fn()
        except Exception as err:
            if not tracing.is_nan_verdict(err):
                raise
            failed = err
    if collectives.any_rank(failed is not None, mesh.device):
        if failed is not None:
            raise FloatingPointError(f"debug_nans: this rank's step: {failed}") from failed
        raise FloatingPointError("debug_nans: another rank's step was not finite")
    return out


def make_eval_step(model: nn.Module, mesh=None) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Returns step(batch) -> mean CTC loss (no dropout or noise), a 0-d
    tensor on the model's device.

    With a ``mesh`` (``parallel.mesh.Mesh``) the step takes the GLOBAL
    batch: this rank evaluates its rows (and time slice) under its
    route's context, then the loss is averaged over every rank
    (``mgr_tpu/train/step.py:323-358``); every rank returns the same
    value."""
    dev = model_device(model)

    def local(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with _shard_context(mesh):
            return _loss_from_batch(model, batch, train=False, rng=None)

    @torch.inference_mode()
    def step(batch: Dict[str, Any]) -> torch.Tensor:
        if mesh is None:
            batch = batch_to_device(batch, dev)
            return _loss_from_batch(model, batch, train=False, rng=None)
        rows = _rank_rows(batch, mesh, dev)
        loss = collectives.pmean(_on_every_rank(mesh, lambda: local(rows)), None)
        tracing.check_finite(loss, "loss")
        return loss

    return step


@dataclasses.dataclass
class TrainState:
    """The step count, the model's parameters by ``state_dict`` name (the
    module's own tensors: a step updates them in place) and the optimizer
    state."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: opt_lib.AdamState

    def snapshot(self) -> "TrainState":
        """A detached copy (the best state kept between checkpoint writes)."""
        return TrainState(
            self.step, {k: v.detach().clone() for k, v in self.params.items()},
            self.opt_state.clone())


def create_train_state(model: nn.Module) -> TrainState:
    """Step 0, the model's current parameters and fresh Adam state."""
    params = dict(model.named_parameters())
    return TrainState(0, params, opt_lib.keras_adam(model.config.optimizer).init(params))


def _loss_and_grads(model: nn.Module, params: Dict[str, torch.Tensor],
                    batch: Dict[str, Any], rng: Optional[prng.Key],
                    local: Callable[[Dict[str, Any]], Dict[str, torch.Tensor]] = lambda mb: mb):
    """Loss and gradients, with ``accum_steps`` microbatches (each with
    its own stream ``fold_in(rng, i)``) whose losses and gradients are
    summed, then scaled by 1/accum (``mgr_tpu/train/step.py:83-125``).
    ``local`` maps a microbatch of ``batch`` to what this process computes
    on (the GSPMD route: a global microbatch to this rank's rows and time
    slice, on its device)."""
    accum = model.config.optimizer.accum_steps
    for p in params.values():
        p.grad = None
    if accum <= 1:
        micro = [(batch, rng)]
    else:
        n = batch["inputs"].shape[0]
        if n % accum:
            raise ValueError(f"batch dim {n} not divisible by accum_steps={accum}")
        m = n // accum
        micro = [({k: v[i * m:(i + 1) * m] for k, v in batch.items()},
                  None if rng is None else prng.fold_in(rng, i))
                 for i in range(accum)]
    loss_sum = None
    with torch.enable_grad():
        for mb, r in micro:
            loss = _loss_from_batch(model, local(mb), train=True, rng=r)
            loss.backward()  # sums into .grad across microbatches
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    if accum <= 1:
        return loss_sum, grads
    inv = 1.0 / accum
    return loss_sum * inv, {k: g * inv for k, g in grads.items()}


def _apply_updates(model: nn.Module, state: TrainState, tx: opt_lib.KerasAdam,
                   loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                   lr_scale: float):
    """Freeze mask, Adam, lr scale, maxnorm, and the global norm of the
    masked gradients (``mgr_tpu/train/step.py:128-141``)."""
    with tracing.annotate("mgr.step.optimizer"):
        grads = opt_lib.freeze_mask_grads(grads, model.trainable())
        with torch.no_grad():
            grad_norm = opt_lib.global_norm(grads)
        tracing.check_finite(grad_norm, "gradient norm")
        updates, opt_state = tx.update(grads, state.opt_state)
        with torch.no_grad():
            new = {k: p + updates[k] * lr_scale for k, p in state.params.items()}
            new = opt_lib.apply_maxnorm(new, model.config.optimizer.maxnorm)
            for k, p in state.params.items():
                p.copy_(new[k])
    state.step += 1
    state.opt_state = opt_state
    for p in state.params.values():
        p.grad = None
    return state, {"loss": loss, "grad_norm": grad_norm}


def _combine(loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
    """The mesh step's loss and gradients, the same on every rank: the mean
    of every rank's over all ranks, one all-reduce. It is the single
    process's for every leaf on both routes.

    Why one uniform mean is exact. Every collective in the forward of a
    mesh step is an all-gather of equal blocks (the two directions on a
    model axis of 2, the time slices and the h blocks of each step on the
    GSPMD route), and its backward is its transpose: the cotangent summed
    over the group, then this rank's block. So the backward of each rank's
    loss L_r gives each rank r a share g_r of the gradient of the sum of
    all ranks' losses: sum_r g_r = grad sum_r L_r. L_r is the mean loss
    of the rows of r's data index d, the same on the M x Tt ranks (model x
    time) of that index, so sum_r L_r = M Tt D L, with L the one-process
    loss of the whole batch, and mean_r g_r = grad L. Leaf by leaf, with
    G_d = grad L_d:

      * a leaf above every exchange, used whole (the head): G_d on every
        rank of index d; the mean over the M Tt copies and the D indices
        is mean_d G_d;
      * a direction-sharded BLSTM leaf (model axis of 2): slot k arrives
        on rank k only, twice G_d's slot k (both ranks' cotangents of
        direction k's stream are summed), zero in the other slot, and a
        leaf below a BLSTM layer holds twice the via-its-direction half on
        each rank (``mgr_tpu/train/step.py:144-161``); the mean over the
        pair gives G_d;
      * an H-sharded LSTM leaf (W, U, b of a layer whose H the model axis
        divides): block m arrives on rank m only, M times G_d's block (the
        exchange's transpose sums the M ranks' cotangents), zero in the
        other blocks, and W's and b's from rank t's time slice only, the
        projection's cotangent Tt times (the time gather's transpose sums
        the Tt ranks'); summed over the M Tt ranks the blocks and slices
        make M Tt G_d;
      * a leaf below a time gather (rgb's CNN, a layer whose recurrence
        every model rank runs whole): the share of rank t's time slice,
        and of every model rank, the same M Tt factor in the sum.

    Where the model axis does not divide H every model rank computes the
    whole layer, and its leaves arrive M Tt times like the head's."""
    both = collectives.pmean_tree({"loss": loss.reshape(1), **grads}, None)
    return both.pop("loss").reshape(()), both


def rank_loss_and_grads(model: nn.Module, mesh, params: Dict[str, torch.Tensor],
                        batch: Dict[str, Any], rng: Optional[prng.Key]):
    """This rank's loss and gradients of a mesh step, on the mesh's route,
    before :func:`_combine` (every rank of the mesh calls it together: the
    route's exchanges run inside). A leaf this rank computes a part of
    holds that part's gradient and zeros elsewhere: one direction's slot on
    a model axis of 2, one block of the hidden units on the GSPMD route.

    On the shard_map route (``local_loss_grad``, ``mgr_tpu/train/step.py:
    194-213``) a rank computes on its rows of the global ``batch``, the
    rng folded by the DATA index only (the two ranks of a model pair draw
    the same masks), under its direction-shard context. On the GSPMD
    route (the ``jax.jit`` step that XLA partitions,
    ``mgr_tpu/train/step.py:282-290``) a rank computes on its rows and
    time slice of each global microbatch under its H-shard context, with
    the rng NOT folded: the draws are one process's, made at the global
    shape (``dispatch.draw_local``)."""
    dev = model_device(model)
    if shard_lib.shardmap_axes(mesh.config) is None:
        whole = {k: batch[k] for k in _keys(batch)}

        def local():
            with _shard_context(mesh):
                return _loss_and_grads(model, params, whole, rng,
                                       local=lambda mb: _rank_rows(mb, mesh, dev))
    else:
        rows = _rank_rows(batch, mesh, dev)
        rng = None if rng is None else prng.fold_in(rng, mesh.data_index)

        def local():
            with _shard_context(mesh):
                return _loss_and_grads(model, params, rows, rng)

    return _on_every_rank(mesh, local)


def mesh_loss_and_grads(model: nn.Module, mesh, params: Dict[str, torch.Tensor],
                        batch: Dict[str, Any], rng: Optional[prng.Key]):
    """The mesh step's loss and gradients before the optimizer: each
    rank's (:func:`rank_loss_and_grads`), combined over every rank
    (:func:`_combine`). Every rank returns the same values. Under
    ``tracing.debug_nans`` the combined loss is checked here and the norm
    of the combined gradients by the optimizer tail, so every rank raises
    at the same step."""
    loss, grads = _combine(*rank_loss_and_grads(model, mesh, params, batch, rng))
    tracing.check_finite(loss, "loss")
    return loss, grads


def make_train_step(model: nn.Module, mesh=None) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch, rng, lr_scale=1.0) -> (state, metrics):
    one optimizer step. ``rng`` (a ``core.prng.Key``) feeds the noise and
    dropout draws; ``lr_scale`` multiplies the updates (the plateau
    controller's scale). metrics: 0-d tensors ``loss`` (mean CTC loss of
    the batch) and ``grad_norm``, left on the device.

    With a ``mesh`` (``parallel.mesh.Mesh``) the step takes the GLOBAL
    batch and computes its loss and gradients with
    :func:`mesh_loss_and_grads` on the mesh's route
    (``_make_shardmap_train_step``, ``mgr_tpu/train/step.py:164-230``, or
    the GSPMD step, ``:259-290``, which warns once per mesh shape); the
    Adam and maxnorm tail then runs on every rank's identical replica."""
    tx = opt_lib.keras_adam(model.config.optimizer)
    dev = model_device(model)
    if mesh is not None and shard_lib.shardmap_axes(mesh.config) is None:
        _warn_gspmd(mesh)

    def step(state: TrainState, batch: Dict[str, Any], rng: Optional[prng.Key],
             lr_scale: float = 1.0):
        if mesh is None:
            batch = batch_to_device(batch, dev)
            loss, grads = _loss_and_grads(model, state.params, batch, rng)
        else:
            loss, grads = mesh_loss_and_grads(model, mesh, state.params, batch, rng)
        return _apply_updates(model, state, tx, loss, grads, lr_scale)

    return step


def make_indexed_train_step(model: nn.Module) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, arrays, idx, rng, lr_scale=1.0) -> (state,
    metrics): :func:`make_train_step`'s step on the rows ``idx`` ((B,)
    int tensor) of ``arrays`` (the corpus on the model's device)."""
    step = make_train_step(model)

    def indexed(state: TrainState, arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                rng: Optional[prng.Key], lr_scale: float = 1.0):
        return step(state, gather_batch(arrays, idx), rng, lr_scale)

    return indexed


def make_indexed_eval_step(model: nn.Module) -> Callable[..., torch.Tensor]:
    """Returns step(arrays, idx) -> mean CTC loss of the rows ``idx``
    (:func:`make_eval_step` on the gathered batch)."""
    step = make_eval_step(model)

    def indexed(arrays: Dict[str, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        return step(gather_batch(arrays, idx))

    return indexed


def make_predict_step(model: nn.Module) -> Callable[[Any], torch.Tensor]:
    """Returns step(inputs) -> (B, T, C) softmax probabilities; ``inputs``
    as the model takes them (the pair for a fusion model)."""
    dev = model_device(model)

    @torch.inference_mode()
    def step(inputs) -> torch.Tensor:
        return torch.softmax(model(to_device(inputs, dev)), dim=-1)

    return step


def make_decode_step(
    model: nn.Module, *, threshold: float, trim_frames: int = 2,
    drop_blank: bool = False, mesh=None,
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Predict and best-path decode on the device.

    Returns step(inputs, input_lengths=None) -> (best, emit), (B, T')
    int32 argmax classes and the bool emit mask: only these reach the
    host, not the (B, T, C) posteriors.

    With a ``mesh`` of the shard_map route (``mgr_tpu/train/step.py:
    378-446``) the step takes the GLOBAL batch: this rank decodes its rows
    (of both streams, for a fusion model) under its direction-shard
    context, and ``(best, emit)`` of the whole batch, in global row order,
    comes back on every rank (gathered over the data group). Without
    ``input_lengths`` every row's length is the inputs' padded T (not
    ``cfg.maxlen``). A mesh of the GSPMD route gets the one-process step,
    as JAX's falls through to the unsharded ``jax.jit(step)``: each rank
    decodes the whole batch."""
    blank = model.config.nb_classes - 1 if drop_blank else None
    dev = model_device(model)

    @torch.inference_mode()
    def step(inputs, input_lengths: Optional[Any] = None):
        with tracing.annotate("mgr.decode.input"):
            x = to_device(inputs, dev)
            lengths = None if input_lengths is None else to_device(input_lengths, dev)
        with tracing.annotate("mgr.decode.forward"):
            probs = torch.softmax(model(x), dim=-1)
            return best_path_decode(
                probs, lengths,
                threshold=threshold, trim_frames=trim_frames, blank=blank,
            )

    if mesh is None or shard_lib.shardmap_axes(mesh.config) is None:
        return step

    @torch.inference_mode()
    def mesh_step(inputs, input_lengths: Optional[Any] = None):
        streams = inputs if isinstance(inputs, tuple) else (inputs,)
        if input_lengths is None:
            B, T = streams[0].shape[:2]
            input_lengths = np.full((B,), T, np.int32)
        rows = shard_lib.shard_batch(
            {"lengths": input_lengths, **{str(i): x for i, x in enumerate(streams)}}, mesh)
        local = tuple(rows[str(i)] for i in range(len(streams)))
        with _shard_context(mesh):
            best, emit = step(local if isinstance(inputs, tuple) else local[0],
                              rows["lengths"])
        return (collectives.all_gather_rows(best, mesh.data_group),
                collectives.all_gather_rows(emit, mesh.data_group))

    return mesh_step
