"""Entry point: the flagship forward pass, as ``__graft_entry__.entry()``
is for the JAX package (``__graft_entry__.py:16-32``).

``entry()`` returns ``(fn, example_args)``: the speech BLSTM model at
the preset's full width with seeded random weights, and a zero batch of
B=8 utterances of T=1900 frames. ``fn(*example_args)`` gives (B, T, 44)
logits. It runs on ``device``: ``cuda`` (the default, through the
kernels; fails without a card) or ``cpu`` (the plain versions), never on
the CPU unless asked.
"""

from __future__ import annotations

import torch

from mgr_tpu_torch.core.config import get_preset
from mgr_tpu_torch.models.zoo import build_model


def entry(device: str = "cuda"):
    cfg = get_preset("speech")
    model = build_model(cfg, device=device)  # raises without a card unless device="cpu"
    x = torch.zeros((8, cfg.maxlen, cfg.num_feats), dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(x):
        return model(x)

    return fn, (x,)
