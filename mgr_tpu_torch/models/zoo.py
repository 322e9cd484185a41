"""The pipeline model families (``mgr_tpu/models/zoo.py``).

Ported so far: the uni-modal family, speech and skeletal
(``_build_unimodal``): encoder, then the dense head. ``apply_tm`` maps
(B, T, F) inputs to (T, B, C) logits, keeping every large tensor
time-major as the kernels want; ``forward`` is its transpose, the (B, T,
C) logits of the JAX ``ModelDef.apply``; with ``train=True`` and a
``core.prng`` key they draw noise and dropout on the JAX package's fold
paths. Parameters are trainable and registered so that ``state_dict()``
keys are the JAX pytree paths joined with dots.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.config import PipelineConfig
from mgr_tpu_torch.models import layers
from mgr_tpu_torch.models.encoder import Encoder

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_NOT_PORTED = {
    "rgb": "the rgb family (CNN frontend) is not ported yet: ROADMAP.md "
           "'Modules to port', item 10",
    "early_fusion": "the early-fusion family is not ported yet: ROADMAP.md "
                    "'Modules to port', item 10",
    "late_fusion": "the late-fusion family is not ported yet: ROADMAP.md "
                   "'Modules to port', item 10",
}


class UnimodalModel(nn.Module):
    """Speech / skeletal: residual BLSTM encoder -> Dense(nb_classes)."""

    def __init__(self, cfg: PipelineConfig, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.encoder = Encoder(cfg.num_feats, cfg.encoder, generator)
        head = layers.init_dense(generator, 2 * cfg.encoder.hidden, cfg.nb_classes)
        if cfg.head_blank_bias:
            head["b"][cfg.nb_classes - 1] = cfg.head_blank_bias
        self.head = layers.Dense(head)

    def apply_tm(self, x: torch.Tensor, *, train: bool = False,
                 rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, F) inputs -> (T, B, C) f32 logits. In train mode the
        encoder draws from ``rng`` and the head's dropout from
        ``fold_name(rng, "head_drop")`` (``mgr_tpu/models/zoo.py:65-98``)."""
        h = self.encoder.apply_tm(
            x.transpose(0, 1), train=train, rng=rng,
            compute_dtype=self.compute_dtype,
        )
        h = layers.dropout(
            h, self.config.encoder.output_dropout,
            None if rng is None else prng.fold_name(rng, "head_drop"), train,
        )
        return self.head(h, self.compute_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, F) inputs -> (B, T, C) f32 logits (``ModelDef.apply``)."""
        return self.apply_tm(x, train=train, rng=rng).transpose(0, 1)

    def trainable(self) -> Dict[str, bool]:
        """Which parameters the optimizer updates, by ``state_dict`` key
        (``_all_trainable``: every leaf of the uni-modal family)."""
        return {name: True for name, _ in self.named_parameters()}


def _build_unimodal(cfg: PipelineConfig, gen: torch.Generator) -> UnimodalModel:
    return UnimodalModel(cfg, gen)


_FAMILIES = {"speech": _build_unimodal, "skeletal": _build_unimodal}


def build_model(
    cfg: PipelineConfig,
    *,
    seed: Optional[int] = None,
    device: torch.device | str = "cpu",
) -> UnimodalModel:
    """Model for ``cfg`` with weights drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (default ``cfg.seed``), then
    moved to ``device``. The draws differ from JAX's for the same seed;
    load weights with ``bridge.params_from_numpy`` to match a JAX model."""
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.name])
    if cfg.name not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.name!r}")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return _FAMILIES[cfg.name](cfg, gen).to(device).eval()
