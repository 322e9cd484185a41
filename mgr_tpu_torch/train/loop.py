"""Training loop: epochs, validation, early stopping, checkpoints, resume
(``mgr_tpu/train/loop.py::fit``), on one device.

Keras-parity semantics, as in the JAX package: shuffle with
``seed + epoch``; a validation pass per epoch without dropout or noise;
the ``monitor``ed loss ("val", or "train") drives the ``best`` slot and
EarlyStopping (stop once ``wait`` reaches ``patience``); the ``latest``
slot every ``checkpoint_every`` epochs; the plateau controller follows its
own monitor (``reduce_lr_monitor``) and keeps its state in the fitmeta
sidecar; ``resume`` restores the ``latest`` slot and refuses a corpus of
another train-batch geometry. Step s draws its noise and dropout from
``fold_in(fold_name(root_key(seed), "dropout"), s)``, so a resumed run
draws what an unbroken one would.

With a ``mesh`` (``parallel.mesh.Mesh``, ``mgr_tpu/train/loop.py:
168-195``) every rank runs this loop: it builds the same global batches
and the mesh steps take its rows; rank 0 alone writes the config, the
slots, the fitmeta and the metrics, and the other ranks wait at a
barrier before they read a checkpoint; the epoch's losses are rank 0's,
broadcast, so that early stopping and the plateau controller decide the
same on every rank (a rank that stopped alone would hang the others at
their next collective).

Not ported yet (ROADMAP.md 'Modules to port', "fit's remaining knobs and
the train CLI's flags"): ``sync_every`` > 1, asynchronous
checkpoints, ``keep_best_state``, ``stop_below`` and the device-resident
dataset path. fit builds its plateau controller from the config and
restores the state on disk into that one only: a caller cannot hand in a
controller of another stage for it to overwrite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    make_train_step,
)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    best_val_loss: float  # least monitored loss seen
    epochs_run: int
    history: list


def fit(
    model: nn.Module,
    data: Batcher,
    *,
    workdir: Optional[str] = None,
    resume: bool = False,
    epochs: Optional[int] = None,
    checkpoint_every: int = 1,
    monitor: str = "val",
    mesh=None,
) -> FitResult:
    """Train one pipeline from the model's current weights; the config's
    seed drives the shuffles and the noise and dropout draws.

    ``checkpoint_every`` — write the latest/best slots at most every N
    epochs; the best state is kept in memory meanwhile and the final
    state always flushed. ``monitor`` — which loss drives the best slot
    and early stopping: "val" (the reference's val_loss) or "train".
    ``mesh`` — train over a mesh of ranks (every rank calls fit; the
    model lives on ``mesh.device``); rank 0's parameters are broadcast to
    every rank first, so the replicas start equal."""
    cfg = model.config
    stamp = cfg.name
    epochs = epochs if epochs is not None else cfg.epochs
    seed = cfg.seed
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
        state = ckpt_lib.load_train_state(workdir, stamp, state)
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

    train_step = make_train_step(model, mesh=mesh)
    eval_step = make_eval_step(model, mesh=mesh)
    metrics = MetricsLogger(writes, stamp, num_chips=1 if mesh is None else mesh.size)
    plateau = opt_lib.plateau_from_config(cfg)
    if plateau is not None and saved_meta.get("plateau"):
        plateau.load_state_dict(saved_meta["plateau"])

    best_val = float("inf") if resumed_best is None else float(resumed_best)

    def _save(slot: str, which: Optional[TrainState] = None) -> None:
        if not writes:
            return
        ckpt_lib.save_train_state(workdir, stamp, which or state, slot=slot)
        meta = {"num_train_batches": num_train_batches}
        if best_val != float("inf"):
            meta["best_val_loss"] = best_val
        if plateau is not None:
            meta["plateau"] = plateau.state_dict()
        ckpt_lib.save_fit_meta(workdir, stamp, meta)

    data_key = prng.fold_name(prng.root_key(seed), "dropout")
    pending_best = None
    wait = 0
    lr_scale = plateau.scale if plateau is not None else 1.0
    history = []
    start_epoch = state.step // num_train_batches
    host_step = state.step
    epoch = start_epoch
    ran_any = False
    for epoch in range(start_epoch, epochs):
        ran_any = True
        metrics.start_epoch(epoch)
        losses, gnorms = [], []
        for _, batch in data.epoch(cfg.batch_size, train=True, shuffle_seed=seed + epoch):
            rng = prng.fold_in(data_key, host_step)
            host_step += 1
            state, m = train_step(state, batch, rng, lr_scale)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        metrics.add_seqs(len(losses) * cfg.batch_size)
        save_now = (epoch - start_epoch + 1) % max(checkpoint_every, 1) == 0
        if save_now:
            _save("latest")

        val_losses = [eval_step(b) for _, b in data.epoch(cfg.batch_size, train=False)]
        nan = float("nan")
        # One host transfer per epoch: the step metrics stay on the device.
        dev = state.params[next(iter(state.params))].device
        nan_t = torch.tensor(nan, device=dev)
        epoch_losses = torch.stack([
            torch.stack(losses).mean() if losses else nan_t,
            torch.stack(gnorms).mean() if gnorms else nan_t,
            torch.stack(val_losses).mean() if val_losses else nan_t,
        ]).float()
        if mesh is not None:  # rank 0's reading decides on every rank
            collectives.broadcast_([epoch_losses])
        train_loss, grad_norm, val_loss = epoch_losses.tolist()
        val_loss = val_loss if val_losses else None
        history.append(metrics.end_epoch(
            train_loss, val_loss, lr_scale=lr_scale, grad_norm=grad_norm))

        monitored = train_loss if (monitor == "train" or val_loss is None) else val_loss
        improved = monitored < best_val
        stop = False
        if improved:
            best_val = monitored
            wait = 0
        else:
            wait += 1
            if wait >= cfg.patience:  # Keras EarlyStopping: wait reaches patience
                stop = True
        if plateau is not None:
            m = train_loss if (cfg.reduce_lr_monitor == "train" or val_loss is None) \
                else monitored
            if m == m:  # skip NaN readings
                lr_scale = plateau.update(m)
        if improved:
            if checkpoint_every > 1:
                pending_best = state.snapshot()
            else:
                _save("best")
        if save_now and pending_best is not None:
            _save("best", pending_best)
            pending_best = None
        if stop:
            break

    # Final flush, only if this call trained: the latest state and the true
    # best state end on disk whatever the checkpoint cadence.
    if ran_any and pending_best is not None:
        _save("best", pending_best)
    if ran_any and checkpoint_every > 1:
        _save("latest")
    metrics.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's last write is on disk when fit returns
    return FitResult(
        state=state, best_val_loss=best_val,
        epochs_run=(epoch - start_epoch + 1) if ran_any else 0,
        history=history,
    )
