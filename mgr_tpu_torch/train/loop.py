"""Training loop: epochs, validation, early stopping, checkpoints, resume
(``mgr_tpu/train/loop.py::fit``), on one device or over a mesh.

Keras-parity semantics, as in the JAX package: shuffle with
``seed + epoch``; a validation pass per sync window without dropout or
noise; the ``monitor``ed loss ("val", or "train") drives the ``best``
slot and EarlyStopping (stop once ``wait`` reaches ``patience``); the
``latest`` slot every ``checkpoint_every`` epochs; the plateau controller
follows its own monitor (``reduce_lr_monitor``) and keeps its state in
the fitmeta sidecar; ``resume`` restores the ``latest`` slot (the port's,
or the JAX package's msgpack) and refuses a corpus of another train-batch
geometry. Step s draws its noise and dropout from
``fold_in(fold_name(root_key(seed), "dropout"), s)``, so a resumed run
draws what an unbroken one would, on either data path.

Two data paths, as in the JAX package. By default (``device_data``) an
array-backed corpus is uploaded to the model's device once and each step
gathers its rows there from a (B,) index (the indexed steps); a lazy
corpus (``LazyVideoBatcher``, which holds no features) and a mesh stream
host batches, one host-to-device copy a step. Both paths take the same
rows and run the same step, so they give the same bits.
``fit(device_data=True, mesh=)`` takes the indexed single-device steps,
as JAX does (``mgr_tpu/train/loop.py:173-187``): every rank trains the
whole batch on its own replica, with no collective in the step.

With a ``mesh`` (``parallel.mesh.Mesh``, ``mgr_tpu/train/loop.py:
168-195``) every rank runs this loop: it builds the same global batches
(two streams, or a lazy corpus's videos, alike) and the mesh steps take
its rows, sliced on the host before their copy to the card, as JAX's
``data.epoch`` then ``shard_batch`` does; rank 0 alone writes the config, the
slots, the fitmeta and the metrics, and the other ranks wait at a
barrier before they read a checkpoint; the window's losses are rank 0's,
broadcast, so that early stopping and the plateau controller decide the
same on every rank (a rank that stopped alone would hang the others at
their next collective).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.metrics import MetricsLogger
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.parallel import collectives
from mgr_tpu_torch.train import optimizer as opt_lib
from mgr_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_indexed_eval_step,
    make_indexed_train_step,
    make_train_step,
    model_device,
)

@dataclasses.dataclass
class FitResult:
    state: TrainState
    # The least monitored loss of any reading. Under sync_every=K>1 this is
    # finer than the states kept: the best state is the window-end state,
    # whose own loss is best_state_loss.
    best_val_loss: float
    epochs_run: int
    history: list
    # fit(keep_best_state=True): a copy of the best state (window-end
    # under sync_every > 1).
    best_state: Optional[TrainState] = None
    # The monitored loss of the state kept as best; NaN when none was.
    best_state_loss: float = float("nan")


def _use_device_data(data: Batcher, mesh, device_data: Optional[bool]) -> bool:
    held = getattr(data, "features", None) is not None
    if device_data is None:
        return mesh is None and held
    if device_data and not held:
        raise ValueError(
            f"fit(device_data=True): {type(data).__name__} holds no features to upload "
            f"(it loads each batch when due); pass device_data=False")
    return bool(device_data)


def fit(
    model: nn.Module,
    data: Batcher,
    *,
    workdir: Optional[str] = None,
    mesh=None,
    resume: bool = False,
    epochs: Optional[int] = None,
    seed: Optional[int] = None,
    metrics: Optional[MetricsLogger] = None,
    async_checkpoints: bool = False,
    device_data: Optional[bool] = None,
    checkpoint_every: int = 1,
    monitor: str = "val",
    keep_best_state: bool = False,
    sync_every: int = 1,
    stop_below: Optional[float] = None,
    plateau_controller: Optional[opt_lib.ReduceLROnPlateau] = None,
) -> FitResult:
    """Train one pipeline from the model's current weights.

    ``seed`` (default the config's) drives the shuffles and the noise and
    dropout draws. ``metrics``: the logger of the epoch records (default
    one writing ``<stamp>_metrics.jsonl`` in ``workdir``; fit closes only
    its own). ``async_checkpoints``: slots and fitmeta written by a
    background thread (``core.checkpoint.AsyncCheckpointer``), drained
    before fit returns.

    ``device_data``: the corpus on the model's device, batches gathered
    there by row index (no host-to-device copy a step). Default: on for
    an array-backed corpus without a mesh; True with a lazy corpus
    raises; True with a mesh trains the whole batch on every rank.

    ``checkpoint_every``: write the latest/best slots at most every N
    epochs; the best state is kept in memory meanwhile and the final
    state always flushed. ``monitor``: the loss that drives the best slot
    and early stopping, "val" (the reference's val_loss) or "train".
    ``keep_best_state``: return a copy of the best state as
    ``FitResult.best_state`` (a second copy of the parameters and the
    moments on the device). ``stop_below``: stop once the monitored loss
    drops below it (the window's bookkeeping still done).

    ``plateau_controller``: a caller-owned ``ReduceLROnPlateau`` kept
    across fit calls (a chunked caller keeps its annealed rate); default
    one built from the config. A resume restores the fitmeta's plateau
    state only into a pristine controller: an annealed one's own state
    is the newer.

    ``sync_every``: the host reads the losses once per window of K
    epochs, one stacked transfer; the val pass runs on window ends only,
    one history record per window (``epochs_in_record``). Best, early
    stop and plateau decide per fetched train loss (or once per window
    under ``monitor="val"``: patience then counts windows, and a warning
    says so); the kept best state is the window-end state. The steps and
    their draws are those of sync_every=1.

    ``mesh``: train over a mesh of ranks (every rank calls fit; the model
    lives on ``mesh.device``); rank 0's parameters are broadcast to every
    rank first, so the replicas start equal."""
    cfg = model.config
    stamp = cfg.name
    epochs = epochs if epochs is not None else cfg.epochs
    seed = seed if seed is not None else cfg.seed
    device_data = _use_device_data(data, mesh, device_data)
    primary = mesh is None or mesh.is_primary
    writes = workdir if primary else None

    num_train_batches = max(data.num_batches(cfg.batch_size, train=True), 1)
    state = create_train_state(model)
    resumed_best = None
    saved_meta = {}
    if mesh is not None:
        mesh.barrier()  # every write of an earlier fit on this workdir is done
    if resume and workdir and ckpt_lib.has_checkpoint(workdir, stamp):
        saved_meta = ckpt_lib.load_fit_meta(workdir, stamp)
        # start_epoch = step // num_batches: a relaunch on a corpus of
        # another geometry would mis-derive it, so refuse.
        if saved_meta.get("num_train_batches") not in (None, num_train_batches):
            raise ValueError(
                f"fit(resume=True) on '{stamp}': this corpus yields "
                f"{num_train_batches} train batches/epoch but the "
                f"checkpoint was written with "
                f"{saved_meta['num_train_batches']} — start_epoch would be "
                f"mis-derived (step // num_batches). Relaunch with the "
                f"original corpus/batch geometry, or start a fresh workdir."
            )
        state = ckpt_lib.load_train_state(workdir, stamp, state,
                                          skip_nonfinite=cfg.optimizer.skip_nonfinite)
        resumed_best = saved_meta.get("best_val_loss")
    if mesh is not None:
        mesh.barrier()  # every rank has read before rank 0 writes
        with torch.no_grad():
            collectives.broadcast_(state.params.values())
    if writes:
        ckpt_lib.save_config(workdir, stamp, cfg)
        meta = {"num_train_batches": num_train_batches}
        if resumed_best is not None:
            meta["best_val_loss"] = resumed_best
        if saved_meta.get("plateau"):
            meta["plateau"] = saved_meta["plateau"]
        ckpt_lib.save_fit_meta(workdir, stamp, meta)

    dev = model_device(model)
    if device_data:
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in data.device_arrays().items()}
        train_step, eval_step = make_indexed_train_step(model), make_indexed_eval_step(model)

        def batches(train: bool, shuffle_seed: Optional[int] = None):
            for _, rows in data.epoch_indices(cfg.batch_size, train=train,
                                              shuffle_seed=shuffle_seed):
                yield arrays, torch.from_numpy(rows).to(dev)
    else:
        train_step, eval_step = make_train_step(model, mesh=mesh), make_eval_step(model, mesh=mesh)

        def batches(train: bool, shuffle_seed: Optional[int] = None):
            for _, batch in data.epoch(cfg.batch_size, train=train, shuffle_seed=shuffle_seed):
                yield (batch,)

    own_metrics = metrics is None
    if own_metrics:
        metrics = MetricsLogger(writes, stamp, num_chips=1 if mesh is None else mesh.size)
    ckpt_writer = ckpt_lib.AsyncCheckpointer(workdir, stamp) \
        if async_checkpoints and writes else None

    plateau = plateau_controller
    if plateau is None:
        plateau = opt_lib.plateau_from_config(cfg)
    if plateau is not None and saved_meta.get("plateau") and plateau.is_pristine():
        plateau.load_state_dict(saved_meta["plateau"])

    sync_every = max(int(sync_every), 1)
    if sync_every > 1 and monitor != "train":
        logging.warning(
            "fit(sync_every=%d, monitor='val'): EarlyStopping patience "
            "%d now counts %d-epoch windows (= %d epochs) and the best "
            "state has window-end granularity",
            sync_every, cfg.patience, sync_every, cfg.patience * sync_every,
        )
    if sync_every > 1 and checkpoint_every < sync_every and workdir:
        logging.warning(
            "fit(sync_every=%d, checkpoint_every=%d): the latest slot "
            "is still written every %d epoch(s); raise checkpoint_every "
            ">= sync_every unless per-epoch serialization is intended",
            sync_every, checkpoint_every, max(checkpoint_every, 1),
        )

    best_val = float("inf") if resumed_best is None else float(resumed_best)

    def _save(slot: str, which: Optional[TrainState] = None) -> None:
        if not writes:
            return
        meta = {"num_train_batches": num_train_batches}
        if best_val != float("inf"):
            meta["best_val_loss"] = best_val
        if plateau is not None:
            meta["plateau"] = plateau.state_dict()
        s = state if which is None else which
        if ckpt_writer is not None:  # the fitmeta goes in the same job, after the slot
            ckpt_writer.save(s, slot=slot, meta=meta)
        else:
            ckpt_lib.save_train_state(workdir, stamp, s, slot=slot)
            ckpt_lib.save_fit_meta(workdir, stamp, meta)

    data_key = prng.fold_name(prng.root_key(seed), "dropout")
    best_state_loss = float("nan")
    pending_best = None
    wait = 0
    lr_scale = plateau.scale if plateau is not None else 1.0
    history = []
    start_epoch = state.step // num_train_batches
    host_step = state.step
    nan_t = torch.tensor(float("nan"), device=dev)
    win_losses, win_gnorms = [], []  # per-epoch mean loss / grad norm, on the device
    stop = False
    epoch = start_epoch
    ran_any = False
    for epoch in range(start_epoch, epochs):
        ran_any = True
        if not win_losses:
            metrics.start_epoch(epoch)  # window start: reset wall and count
        else:
            metrics.note_epoch(epoch)
        losses, gnorms = [], []
        for args in batches(True, seed + epoch):
            rng = prng.fold_in(data_key, host_step)
            host_step += 1
            state, m = train_step(state, *args, rng, lr_scale)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        win_losses.append(torch.stack(losses).mean() if losses else nan_t)
        win_gnorms.append(torch.stack(gnorms).mean() if gnorms else nan_t)
        metrics.add_seqs(len(losses) * cfg.batch_size)
        save_now = (epoch - start_epoch + 1) % max(checkpoint_every, 1) == 0
        if save_now:
            _save("latest")
        if len(win_losses) < sync_every and epoch != epochs - 1:
            continue  # no host read until the window ends

        # Window end: the val pass, then ONE host transfer of the window's
        # losses and grad norms and the val mean.
        val_losses = [eval_step(*args) for args in batches(False)]
        n_win = len(win_losses)
        fetched = torch.stack(win_losses + win_gnorms + [
            torch.stack(val_losses).mean() if val_losses else nan_t]).float()
        if mesh is not None:  # rank 0's reading decides on every rank
            collectives.broadcast_([fetched])
        fetched = fetched.tolist()
        train_seq = fetched[:n_win]
        grad_norm = fetched[2 * n_win - 1]
        val_loss = fetched[2 * n_win] if val_losses else None
        history.append(metrics.end_epoch(
            train_seq[-1], val_loss, lr_scale=lr_scale, grad_norm=grad_norm,
            **({"epochs_in_record": n_win} if sync_every > 1 else {})))

        # Best and early stop per fetched train loss, or once per window on
        # the val loss; the plateau controller follows its own monitor.
        monitored_seq = train_seq if (monitor == "train" or val_loss is None) else [val_loss]
        improved_in_window = False
        for monitored in monitored_seq:
            if monitored < best_val:
                best_val = monitored
                wait = 0
                improved_in_window = True
                if stop_below is not None and monitored < stop_below:
                    stop = True
            else:
                wait += 1
                if wait >= cfg.patience:  # Keras EarlyStopping: wait reaches patience
                    stop = True
        if plateau is not None:
            plateau_seq = train_seq if (cfg.reduce_lr_monitor == "train" or val_loss is None) \
                else monitored_seq
            for m in plateau_seq:
                if m == m:  # skip NaN readings
                    lr_scale = plateau.update(m)
        if improved_in_window:
            best_state_loss = monitored_seq[-1]
            if checkpoint_every > 1 or keep_best_state:
                pending_best = state.snapshot()  # the step updates state in place
            if checkpoint_every <= 1:
                _save("best")
        if save_now and pending_best is not None and checkpoint_every > 1:
            _save("best", pending_best)
            if not keep_best_state:
                pending_best = None
        win_losses, win_gnorms = [], []
        if stop:
            break

    # Final flush, only if this call trained: the latest state and the true
    # best state end on disk whatever the checkpoint cadence.
    if ran_any and pending_best is not None and checkpoint_every > 1:
        _save("best", pending_best)
    if ran_any and checkpoint_every > 1:
        _save("latest")
    if ckpt_writer is not None:
        ckpt_writer.wait()
    if own_metrics:
        metrics.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's last write is on disk when fit returns
    return FitResult(
        state=state, best_val_loss=best_val,
        epochs_run=(epoch - start_epoch + 1) if ran_any else 0,
        history=history,
        best_state=pending_best if keep_best_state else None,
        best_state_loss=best_state_loss,
    )
