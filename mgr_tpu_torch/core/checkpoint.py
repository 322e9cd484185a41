"""Checkpoint store in the port's own format, and a reader of the JAX
package's.

Counterpart of ``mgr_tpu/core/checkpoint.py``. Layout inside a workdir:

    <stamp>_config.json       pipeline config (``PipelineConfig.to_json``)
    <stamp>_<slot>.state.pt   a whole train state in one file: the
                              parameters, the step and the optimizer's
                              state (Adam moments, counts)
    <stamp>_<slot>.params.pt  ``torch.save`` of the model's state dict
                              (keys = JAX pytree paths joined with dots)
    <stamp>_fitmeta.json      facts fit(resume=True) needs: batches per
                              epoch, best monitored loss, plateau state

Every write is atomic (tmp + rename). A train-state slot is ``state.pt``
alone, written before the slot's ``params.pt``: a save killed between the
two leaves a slot that resumes wholly from the new save and a complete
``params.pt`` of the one before (decode and evaluate read ``params.pt``),
so preemption mid-save never mixes two saves. :class:`AsyncCheckpointer`
writes the same files in the same order from a background thread.

A workdir of the JAX package holds ``<stamp>_<slot>.msgpack`` slots (flax
msgpack of JAX's ``TrainState``: ``step``, ``params``, ``opt_state``),
read by ``core/msgpack.py``. Where a slot has no file of the port's own,
``has_checkpoint``, ``read_params``, ``load_params`` and
``load_train_state`` read the JAX slot instead: the port never writes
msgpack, so its own file is the newer one. The config, the fitmeta and
the JAX parameter paths are the same in both packages; rgb's conv kernels
are HWIO in both, copied as they are.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from mgr_tpu_torch.bridge import flatten
from mgr_tpu_torch.core import msgpack
from mgr_tpu_torch.core.config import PipelineConfig


def _atomic_save(obj, path: str) -> str:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def params_path(workdir: str, stamp: str, slot: str = "best") -> str:
    return os.path.join(workdir, f"{stamp}_{slot}.params.pt")


def jax_slot_path(workdir: str, stamp: str, slot: str = "latest") -> str:
    """The JAX package's slot (``mgr_tpu/core/checkpoint.py::_path``)."""
    return os.path.join(workdir, f"{stamp}_{slot}.msgpack")


def save_config(workdir: str, stamp: str, cfg: PipelineConfig) -> None:
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{stamp}_config.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(cfg.to_json())
    os.replace(tmp, path)


def load_config(workdir: str, stamp: str) -> PipelineConfig:
    with open(os.path.join(workdir, f"{stamp}_config.json")) as f:
        return PipelineConfig.from_json(f.read())


def save_params(workdir: str, stamp: str, model: nn.Module, *,
                slot: str = "best") -> str:
    os.makedirs(workdir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return _atomic_save(state, params_path(workdir, stamp, slot))


def read_jax_checkpoint(workdir: str, stamp: str, *, slot: str = "latest") -> Dict[str, Any]:
    """A JAX slot as flax wrote it: a nested dict of numpy arrays (a
    bfloat16 leaf is a ``torch.bfloat16`` tensor), keyed as flax keys
    JAX's ``TrainState``: ``step``, ``params``, and ``opt_state`` with an
    optax chain keyed "0", "1", "2" and ``apply_if_finite``'s fields
    around it."""
    with open(jax_slot_path(workdir, stamp, slot), "rb") as f:
        tree = msgpack.restore(f.read())
    if not (isinstance(tree, dict) and isinstance(tree.get("params"), dict)):
        raise ValueError(f"{jax_slot_path(workdir, stamp, slot)}: not a JAX TrainState "
                         f"(no 'params' map)")
    return tree


def _tensors(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A nested dict of arrays -> {dotted path: tensor}, bits unchanged."""
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            for k, v in flatten(tree).items()}


def _same_layout(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], what: str):
    if got.keys() != want.keys():
        raise ValueError(f"{what}: keys {sorted(set(got) ^ set(want))} differ from the model's")
    for k, v in got.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, the model "
                             f"{tuple(want[k].shape)}")


def read_params(workdir: str, stamp: str, *, slot: str = "best") -> dict:
    """A slot's parameters as a state dict on the CPU: the port's
    ``params.pt``, or else the ``params`` of the JAX slot."""
    path = params_path(workdir, stamp, slot)
    if not os.path.exists(path) and os.path.exists(jax_slot_path(workdir, stamp, slot)):
        return _tensors(read_jax_checkpoint(workdir, stamp, slot=slot)["params"])
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params(workdir: str, stamp: str, model: nn.Module, *,
                slot: str = "best") -> nn.Module:
    """Load a slot into ``model`` (same config: keys and shapes match)."""
    model.load_state_dict(read_params(workdir, stamp, slot=slot), strict=True)
    return model


def state_path(workdir: str, stamp: str, slot: str = "latest") -> str:
    return os.path.join(workdir, f"{stamp}_{slot}.state.pt")


def _host_copy(x):
    """``x`` (tensors in nested dicts) copied to the CPU. A copy even of a
    CPU tensor: the train step updates the parameters in place, so a slot
    written later must not share their storage."""
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def _host_state(state) -> dict:
    """What a slot holds: the parameters, the step, the optimizer state."""
    return {"params": _host_copy(state.params), "step": int(state.step),
            "opt_state": _host_copy(state.opt_state.state_dict())}


def _write_slot(workdir: str, stamp: str, host: dict, slot: str) -> str:
    """``state.pt`` first (the slot's commit point), then ``params.pt``."""
    os.makedirs(workdir, exist_ok=True)
    _atomic_save(host, state_path(workdir, stamp, slot))
    return _atomic_save(host["params"], params_path(workdir, stamp, slot))


def save_train_state(workdir: str, stamp: str, state, *, slot: str = "latest") -> str:
    """Write a train state (``train.step.TrainState``) to a slot: the
    whole state as ``state.pt`` (what a resume reads), then its
    parameters again as ``params.pt`` (what decode reads)."""
    return _write_slot(workdir, stamp, _host_state(state), slot)


def _copy_params_into(state, params: Dict[str, torch.Tensor], what: str) -> torch.device:
    _same_layout(params, state.params, what)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
    return next(iter(state.params.values())).device


def load_train_state(workdir: str, stamp: str, state, *, slot: str = "latest",
                     skip_nonfinite: int = 0):
    """Restore a slot into ``state`` (same config), in place: parameters
    copied into the model's tensors, step and optimizer state replaced (on
    the parameters' device). Reads the slot's ``state.pt``, or else the
    JAX slot (:func:`load_jax_train_state`, whose optimizer layout depends
    on ``skip_nonfinite``). Returns ``state``."""
    from mgr_tpu_torch.train.optimizer import AdamState

    path = state_path(workdir, stamp, slot)
    if not os.path.exists(path) and os.path.exists(jax_slot_path(workdir, stamp, slot)):
        return load_jax_train_state(workdir, stamp, state, slot=slot,
                                    skip_nonfinite=skip_nonfinite)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    dev = _copy_params_into(state, saved["params"], f"checkpoint {stamp}/{slot}")

    def to_dev(x):
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        return x.to(dev)

    state.step = int(saved["step"])
    state.opt_state = AdamState(**to_dev(saved["opt_state"]))
    return state


def _keys(tree: Any, want: set, what: str) -> dict:
    if not isinstance(tree, dict) or set(tree) != want:
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{what} holds {got}, expected {sorted(want)}")
    return tree


def _jax_adam_state(opt: Any, params: Dict[str, torch.Tensor], *, wrapped: bool,
                    dev: torch.device):
    """optax's state of ``keras_adam``'s chain -> ``AdamState``: clip (no
    state), ``scale_by_adam`` (count, mu, nu), ``scale_by_schedule``
    (count), inside ``apply_if_finite`` when ``wrapped``. Raises
    ``ValueError`` when the stored layout is another."""
    from mgr_tpu_torch.train.optimizer import AdamState

    def count(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    notfinite = total = 0
    chain = opt
    if wrapped:
        outer = _keys(opt, {"notfinite_count", "last_finite", "total_notfinite", "inner_state"},
                      "apply_if_finite's state")
        notfinite, total, chain = (outer["notfinite_count"], outer["total_notfinite"],
                                   outer["inner_state"])
    chain = _keys(chain, {"0", "1", "2"}, "the optax chain (clip, scale_by_adam, "
                                          "scale_by_schedule)")
    _keys(chain["0"], set(), "clip's state")
    adam = _keys(chain["1"], {"count", "mu", "nu"}, "scale_by_adam's state")
    sched = _keys(chain["2"], {"count"}, "scale_by_schedule's state")
    mu, nu = _tensors(adam["mu"]), _tensors(adam["nu"])
    _same_layout(mu, params, "Adam's mu")
    _same_layout(nu, params, "Adam's nu")
    return AdamState(
        count=count(adam["count"]),
        mu={k: v.to(dev) for k, v in mu.items()},
        nu={k: v.to(dev) for k, v in nu.items()},
        schedule_count=count(sched["count"]),
        notfinite_count=count(notfinite),
        total_notfinite=count(total),
    )


def load_jax_train_state(workdir: str, stamp: str, state, *, slot: str = "latest",
                         skip_nonfinite: int = 0):
    """Restore the JAX package's ``<stamp>_<slot>.msgpack`` into ``state``
    in place: the parameters (bit for bit), the step, and optax's chain
    state mapped onto ``AdamState``. ``skip_nonfinite`` is the resuming
    config's (``OptimizerConfig.skip_nonfinite``): non-zero expects the
    chain inside ``apply_if_finite``.

    When the stored optimizer layout is another (``skip_nonfinite`` was
    toggled between the save and the resume), this restores the
    parameters and the step only, as ``load_checkpoint_flexible``
    (``mgr_tpu/core/checkpoint.py:99-164``) does: ``state``'s own
    (fresh) moments stay, the schedule count is rewound to the step, and
    a warning says so. Parameters of another layout raise."""
    where = f"checkpoint {stamp}/{slot}"
    tree = read_jax_checkpoint(workdir, stamp, slot=slot)
    params = _tensors(tree["params"])
    dev = _copy_params_into(state, params, where)
    state.step = int(np.asarray(tree.get("step", 0)))
    try:
        state.opt_state = _jax_adam_state(tree.get("opt_state"), params,
                                          wrapped=bool(skip_nonfinite), dev=dev)
    except ValueError as exc:
        logging.warning(
            "checkpoint %s/%s: optimizer state layout mismatch (%s); "
            "restored params+step only, optimizer moments reset "
            "(LR-schedule count rewound to step %d)",
            stamp, slot, exc, state.step,
        )
        state.opt_state.schedule_count = torch.tensor(state.step, dtype=torch.int32,
                                                      device=dev)
    return state


def has_checkpoint(workdir: str, stamp: str, slot: str = "latest") -> bool:
    """A train-state slot of the port's (``state.pt``) or of the JAX
    package's (``.msgpack``)."""
    return (os.path.exists(state_path(workdir, stamp, slot))
            or os.path.exists(jax_slot_path(workdir, stamp, slot)))


def save_fit_meta(workdir: str, stamp: str, meta: dict) -> None:
    """Sidecar facts about the run that wrote the checkpoints: batches per
    epoch (fit(resume=True) derives its start epoch as step // batches),
    the best monitored loss, the plateau controller's state."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{stamp}_fitmeta.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def load_fit_meta(workdir: str, stamp: str) -> dict:
    try:
        with open(os.path.join(workdir, f"{stamp}_fitmeta.json")) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


class AsyncCheckpointer:
    """Writes train-state slots from a background thread
    (``mgr_tpu/core/checkpoint.py:203-248``), so the train loop does not
    wait on the disk.

    ``save()`` copies the state to the host before it returns (the next
    step updates the parameters in place), then queues the slot's writes
    (``state.pt``, then ``params.pt``) and, after them, the fitmeta
    ``meta`` that goes with that save: the sidecar on disk is never newer
    than the slots. Jobs run one at a time in the order queued; a newer
    save of a slot still queued replaces it and moves to the back. The
    first failed write stops the writer and drops what is queued; it is
    raised by the next ``save()`` or by ``wait()``, which drains the
    queue (call it before reading what was saved)."""

    def __init__(self, workdir: str, stamp: str):
        self.workdir = workdir
        self.stamp = stamp
        self._lock = threading.Lock()
        self._pending: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state, *, slot: str = "latest", meta: Optional[dict] = None) -> None:
        host = _host_state(state)
        with self._lock:
            if self._error is not None:
                raise self._error
            self._pending.pop(slot, None)
            self._pending[slot] = (host, meta)
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._running = False
                    return
                slot, (host, meta) = self._pending.popitem(last=False)
            try:
                _write_slot(self.workdir, self.stamp, host, slot)
                if meta is not None:
                    save_fit_meta(self.workdir, self.stamp, meta)
            except Exception as exc:  # raised to the caller by save() / wait()
                with self._lock:
                    self._error = exc
                    self._pending.clear()
                    self._running = False
                return

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
        if self._error is not None:
            raise self._error
