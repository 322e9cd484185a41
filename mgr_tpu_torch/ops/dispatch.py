"""Kernel dispatch rule and launch counters.

Counterpart of ``mgr_tpu/ops/dispatch.py``, reduced to one rule: a
tensor on a CUDA device goes to the hand-written kernel, a tensor on the
CPU goes to the kernel's plain PyTorch version. There is no mode switch
and no environment variable, and a CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

Each kernel wrapper adds one to its counter where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels (``chip_smoke.py`` resets the counters, drives the
serving and training paths and reads them back).
"""

from __future__ import annotations

from typing import Dict

import torch

KERNELS = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd")

_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version).

    Raises on a mix of devices or on any other device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"kernel operands must all be on one CUDA device or all on the "
        f"CPU, got {sorted(kinds)}"
    )


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)
