"""Checkpoint store in the port's own format.

Counterpart of ``mgr_tpu/core/checkpoint.py``. Layout inside a workdir:

    <stamp>_config.json       pipeline config (``PipelineConfig.to_json``)
    <stamp>_<slot>.params.pt  ``torch.save`` of the model's state dict
                              (keys = JAX pytree paths joined with dots)

Writes are atomic (tmp + rename). Reading the JAX package's msgpack
checkpoints is not ported yet (ROADMAP.md 'Modules to port', item 9);
until then, the weight bridge (``mgr_tpu_torch.bridge``) moves weights
across from numpy.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from mgr_tpu_torch.core.config import PipelineConfig


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
    path = params_path(workdir, stamp, slot)
    tmp = path + ".tmp"
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_params(workdir: str, stamp: str, model: nn.Module, *,
                slot: str = "best") -> nn.Module:
    """Load a slot into ``model`` (same config: keys and shapes match)."""
    state = torch.load(params_path(workdir, stamp, slot),
                       map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
