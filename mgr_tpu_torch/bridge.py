"""Weight bridge between the JAX package's params and the port's modules.

The JAX params are a nested dict (``params["encoder"]["blstm_0"]["W"]``);
the port's ``state_dict()`` keys are the same paths joined with dots
(``encoder.blstm_0.W``). Both directions copy values bit for bit, in
float32, with numpy arrays as the exchange format so that neither side
imports the other's framework.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a.b.c": leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": leaf} -> nested dict."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def params_from_numpy(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params as a nested dict of numpy arrays -> a state dict."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in flatten(tree).items()
    }


def params_to_numpy(module: nn.Module) -> Dict[str, Any]:
    """A module's parameters -> JAX-shaped nested dict of numpy arrays."""
    return unflatten({
        k: v.detach().to("cpu", torch.float32).numpy().copy()
        for k, v in module.state_dict().items()
    })


def load_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy JAX params into ``module`` (keys and shapes must match)."""
    module.load_state_dict(params_from_numpy(tree), strict=True)
    return module
