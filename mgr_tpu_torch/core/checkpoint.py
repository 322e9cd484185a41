"""Checkpoint store in the port's own format.

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
so preemption mid-save never mixes two saves. Reading the JAX package's
msgpack checkpoints is not ported yet (ROADMAP.md 'Modules to port', 'A
msgpack reader for JAX checkpoints'); until then, the weight bridge (``mgr_tpu_torch.bridge``) moves
weights across from numpy.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from mgr_tpu_torch.core.config import PipelineConfig


def _atomic_save(obj, path: str) -> str:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def params_path(workdir: str, stamp: str, slot: str = "best") -> str:
    return os.path.join(workdir, f"{stamp}_{slot}.params.pt")


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


def read_params(workdir: str, stamp: str, *, slot: str = "best") -> dict:
    """A slot's parameters as a state dict on the CPU."""
    return torch.load(params_path(workdir, stamp, slot), map_location="cpu",
                      weights_only=True)


def load_params(workdir: str, stamp: str, model: nn.Module, *,
                slot: str = "best") -> nn.Module:
    """Load a slot into ``model`` (same config: keys and shapes match)."""
    model.load_state_dict(read_params(workdir, stamp, slot=slot), strict=True)
    return model


def state_path(workdir: str, stamp: str, slot: str = "latest") -> str:
    return os.path.join(workdir, f"{stamp}_{slot}.state.pt")


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_train_state(workdir: str, stamp: str, state, *, slot: str = "latest") -> str:
    """Write a train state (``train.step.TrainState``) to a slot: the
    whole state as ``state.pt`` (what a resume reads), then its
    parameters again as ``params.pt`` (what decode reads)."""
    os.makedirs(workdir, exist_ok=True)
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    _atomic_save({"params": params, "step": int(state.step),
                  "opt_state": _to_cpu(state.opt_state.state_dict())},
                 state_path(workdir, stamp, slot))
    return _atomic_save(params, params_path(workdir, stamp, slot))


def load_train_state(workdir: str, stamp: str, state, *, slot: str = "latest"):
    """Restore a slot's ``state.pt`` into ``state`` (same config), in
    place: parameters copied into the model's tensors, step and optimizer
    state replaced (on the parameters' device). Returns ``state``."""
    from mgr_tpu_torch.train.optimizer import AdamState

    saved = torch.load(state_path(workdir, stamp, slot), map_location="cpu",
                       weights_only=True)
    params = saved["params"]
    if params.keys() != state.params.keys():
        raise ValueError(f"checkpoint {stamp}/{slot}: parameters differ from the model's")
    dev = next(iter(state.params.values())).device
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])

    def to_dev(x):
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        return x.to(dev)

    state.step = int(saved["step"])
    state.opt_state = AdamState(**to_dev(saved["opt_state"]))
    return state


def has_checkpoint(workdir: str, stamp: str, slot: str = "latest") -> bool:
    return os.path.exists(state_path(workdir, stamp, slot))


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
