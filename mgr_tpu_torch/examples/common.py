"""What the learning drivers share: the device rule, evaluation of a given
set of parameters, and the command line.

The JAX drivers' ``evaluate_accuracy(model, params, data)`` scores any
parameter tree; the port's scores the module's own weights, so
:func:`params_loaded` puts a state's parameters into the module for the
call and takes the module's back afterwards.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Callable, Dict, Iterator, Optional

import torch


def resolve_device(device: str, prog: str) -> str:
    """``device``, or a RuntimeError naming ``--device cpu`` when it is a
    card this host lacks: a driver never falls back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{prog}: no CUDA device on this host; pass --device cpu "
                           f"to run the plain versions on the CPU")
    return device


@contextlib.contextmanager
def params_loaded(model, params: Dict[str, torch.Tensor]) -> Iterator[None]:
    """``model`` holding ``params`` (a state's, by parameter name) inside the
    block, its own parameters again after it."""
    own = {name: p.detach().clone() for name, p in model.named_parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    try:
        yield
    finally:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(own[name])


def run_cli(main: Callable[..., dict], description: str,
            positional: Optional[dict] = None) -> None:
    """``python -m mgr_tpu_torch.examples.<driver> [ARG] [--device cpu]``:
    blocks the JAX package's imports (the port stands alone), then calls
    ``main(..., device=...)``."""
    for name in ("jax", "flax", "mgr_tpu"):
        sys.modules[name] = None
    parser = argparse.ArgumentParser(description=description)
    if positional:
        parser.add_argument(positional["name"], nargs="?", default=positional["default"],
                            choices=positional.get("choices"))
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the first card, through the kernels) or cpu")
    args = vars(parser.parse_args())
    main(**args)
