"""The pipeline model families (``mgr_tpu/models/zoo.py``).

All five families: the uni-modal family, speech and skeletal
(``_build_unimodal``): encoder, then the dense head; rgb (``_build_rgb``):
the CNN frontend over every frame, the encoder on its 768 features a
frame, the head; early fusion (``_build_early_fusion``):
noise on each stream, a channel concat, the encoder, the head; late
fusion (``_build_late_fusion``): two encoders built from the source
pipelines' configs, re-applied to their streams, a concat, a BiLSTM of
width ``fusion_hidden`` and the head. ``apply_tm`` maps (B, T, F) inputs
(a pair of them for the fusion families, (B, T, D, D, 1) video for rgb)
to (T, B, C) logits, keeping
every large tensor time-major as the kernels want; ``forward`` is its
transpose, the (B, T, C) logits of the JAX ``ModelDef.apply``; with
``train=True`` and a ``core.prng`` key they draw noise and dropout on the
JAX package's fold paths. Parameters are registered so that
``state_dict()`` keys are the JAX pytree paths joined with dots.

``trainable()`` marks what the optimizer updates. Late fusion freezes its
grafted encoders unless ``finetune_encoders``; a frozen encoder runs
outside autograd, so a train step computes no backward through it, as
XLA compiles the JAX step whose frozen gradients are replaced by zeros.

On a mesh with a model axis every BLSTM layer of every family, the frozen
encoders' included, runs its rank's direction under the direction-shard
context that the mesh step sets around the model
(``ops.lstm.bilstm_layer_tm``); the rest of a model (rgb's CNN frontend,
the noise, the concat, the head) runs on both ranks of a model pair, on
the same rows. On the GSPMD route (``ops.dispatch.h_shard``) the inputs
are this rank's rows and time slice: the first stage (the noise, early
fusion's two streams and their concat, rgb's CNN on its frames) runs on
the slice, every BLSTM layer (the frozen encoders' too) takes its slice
and gives the whole stream, and the head and its dropout run on the whole
stream of the rank's rows.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from mgr_tpu_torch.core import prng, tracing
from mgr_tpu_torch.core.config import PipelineConfig, get_preset
from mgr_tpu_torch.models import layers
from mgr_tpu_torch.models.encoder import BiLSTM, Encoder
from mgr_tpu_torch.ops import dispatch, lstm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Inputs = torch.Tensor | Tuple[torch.Tensor, torch.Tensor]


def _head(generator: torch.Generator, in_dim: int, cfg: PipelineConfig) -> layers.Dense:
    head = layers.init_dense(generator, in_dim, cfg.nb_classes)
    if cfg.head_blank_bias:
        head["b"][cfg.nb_classes - 1] = cfg.head_blank_bias
    return layers.Dense(head)


def _sub(rng: Optional[prng.Key], name: str) -> Optional[prng.Key]:
    return None if rng is None else prng.fold_name(rng, name)


class _Model(nn.Module):
    """What every family shares: the config, the compute dtype, the head
    with its dropout, ``forward`` and ``trainable``."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        self.config = cfg
        self.compute_dtype = DTYPES[cfg.compute_dtype]

    def _head_apply(self, h: torch.Tensor, rate: float, *, train: bool,
                    rng: Optional[prng.Key]) -> torch.Tensor:
        """Dropout from ``fold_name(rng, "head_drop")``, then the head: f32
        logits (``mgr_tpu/models/zoo.py:65-70``)."""
        h = layers.dropout(h, rate, _sub(rng, "head_drop"), train, batch_axis=1)
        return self.head(h, self.compute_dtype)

    def forward(self, x: Inputs, *, train: bool = False,
                rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, F) inputs -> (B, T, C) f32 logits (``ModelDef.apply``)."""
        return self.apply_tm(x, train=train, rng=rng).transpose(0, 1)

    def trainable(self) -> Dict[str, bool]:
        """Which parameters the optimizer updates, by ``state_dict`` key
        (``_all_trainable``: every leaf)."""
        return {name: True for name, _ in self.named_parameters()}


class UnimodalModel(_Model):
    """Speech / skeletal: residual BLSTM encoder -> Dense(nb_classes)."""

    def __init__(self, cfg: PipelineConfig, generator: torch.Generator):
        super().__init__(cfg)
        self.encoder = Encoder(cfg.num_feats, cfg.encoder, generator)
        self.head = _head(generator, 2 * cfg.encoder.hidden, cfg)

    def apply_tm(self, x: torch.Tensor, *, train: bool = False,
                 rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, F) inputs -> (T, B, C) f32 logits. In train mode the
        encoder draws from ``rng`` and the head's dropout from
        ``fold_name(rng, "head_drop")`` (``mgr_tpu/models/zoo.py:65-98``)."""
        h = self.encoder.apply_tm(
            x.transpose(0, 1), train=train, rng=rng,
            compute_dtype=self.compute_dtype,
        )
        return self._head_apply(h, self.config.encoder.output_dropout, train=train, rng=rng)


class RGBModel(_Model):
    """RGB: submodules ``cnn`` (the conv frontend), ``encoder`` (a residual
    BLSTM on the frontend's ``cnn_output_dim`` features, not the preset's
    ``num_feats``) and ``head`` (``_build_rgb``, ``mgr_tpu/models/zoo.py:
    110-149``)."""

    def __init__(self, cfg: PipelineConfig, generator: torch.Generator):
        super().__init__(cfg)
        self.cnn = layers.CNN(layers.init_cnn(generator, cfg.cnn), cfg.cnn)
        self.encoder = Encoder(layers.cnn_output_dim(cfg.cnn), cfg.encoder, generator)
        self.head = _head(generator, 2 * cfg.encoder.hidden, cfg)

    def apply_tm(self, x: torch.Tensor, *, train: bool = False,
                 rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, D, D, 1) video -> (T, B, C) f32 logits. With
        ``cfg.cnn.remat`` and grad enabled the frontend runs under
        ``torch.utils.checkpoint`` (``jax.checkpoint`` in JAX): its
        activations, the largest tensors of the step, are recomputed in
        the backward instead of stored."""
        cfg = self.config
        if cfg.cnn.remat and torch.is_grad_enabled():
            feats = torch.utils.checkpoint.checkpoint(
                self.cnn, x, self.compute_dtype, use_reentrant=False)
        else:
            feats = self.cnn(x, self.compute_dtype)
        h = self.encoder.apply_tm(
            feats.transpose(0, 1), train=train, rng=rng, compute_dtype=self.compute_dtype,
        )
        return self._head_apply(h, cfg.encoder.output_dropout, train=train, rng=rng)


class EarlyFusionModel(_Model):
    """Early fusion: noise on each stream, a channel concat (39 + 20), the
    residual BLSTM encoder, Dense(nb_classes) (``_build_early_fusion``,
    ``mgr_tpu/models/zoo.py:157-198``)."""

    def __init__(self, cfg: PipelineConfig, generator: torch.Generator):
        super().__init__(cfg)
        self.encoder = Encoder(cfg.num_feats + cfg.second_stream_feats, cfg.encoder, generator)
        self.head = _head(generator, 2 * cfg.encoder.hidden, cfg)

    def apply_tm(self, inputs: Tuple[torch.Tensor, torch.Tensor], *, train: bool = False,
                 rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, F_a) and (B, T, F_s) inputs -> (T, B, C) f32 logits. Each
        stream gets its own noise (the config's ``encoder.input_noise`` from
        ``"noise_a"``, ``second_stream_noise`` from ``"noise_s"``) BEFORE the
        concat, and the encoder adds none of its own."""
        cfg = self.config
        x_a, x_s = inputs
        x_a = layers.gaussian_noise(x_a, cfg.encoder.input_noise, _sub(rng, "noise_a"), train,
                                    batch_axis=0, time_axis=1)
        x_s = layers.gaussian_noise(x_s, cfg.second_stream_noise, _sub(rng, "noise_s"), train,
                                    batch_axis=0, time_axis=1)
        x = torch.cat([x_a, x_s], dim=2)
        h = self.encoder.apply_tm(
            x.transpose(0, 1), train=train, rng=rng,
            compute_dtype=self.compute_dtype, noise_override=0.0,
        )
        return self._head_apply(h, cfg.encoder.output_dropout, train=train, rng=rng)


class LateFusionModel(_Model):
    """Late fusion: submodules ``speech`` and ``skeletal`` (encoders built
    from the source pipelines' configs, each keeping its own dropout
    rates), ``fusion`` (one BiLSTM of width ``fusion_hidden`` over the
    concat of their residual streams) and ``head``: the JAX pytree's keys
    (``_build_late_fusion``, ``mgr_tpu/models/zoo.py:208-285``)."""

    def __init__(self, cfg: PipelineConfig, generator: torch.Generator,
                 source_configs: Dict[str, PipelineConfig]):
        super().__init__(cfg)
        sp, sk = source_configs["speech"], source_configs["skeletal"]
        self.source_configs = {"speech": sp, "skeletal": sk}
        self.speech = Encoder(sp.num_feats, sp.encoder, generator)
        self.skeletal = Encoder(sk.num_feats, sk.encoder, generator)
        concat = 2 * sp.encoder.hidden + 2 * sk.encoder.hidden
        self.fusion = BiLSTM(lstm.init_bilstm_params(generator, concat, cfg.fusion_hidden))
        self.head = _head(generator, 2 * cfg.fusion_hidden, cfg)

    def _encode(self, name: str, x: torch.Tensor, noise: float, *, train: bool,
                rng: Optional[prng.Key]) -> torch.Tensor:
        """Encoder ``name`` re-applied time-major under ``noise``; a frozen
        encoder outside autograd (no c streams stored, no backward)."""
        frozen = not self.config.finetune_encoders
        with torch.no_grad() if frozen else contextlib.nullcontext():
            return getattr(self, name).apply_tm(
                x.transpose(0, 1), train=train, rng=rng,
                compute_dtype=self.compute_dtype, noise_override=noise,
            )

    def apply_tm(self, inputs: Tuple[torch.Tensor, torch.Tensor], *, train: bool = False,
                 rng: Optional[prng.Key] = None) -> torch.Tensor:
        """(B, T, 39) audio and (B, T, 20) skeletal inputs -> (T, B, C) f32
        logits. The speech encoder under the config's ``encoder.input_noise``
        with ``fold_name(rng, "enc_a")``, the skeletal one under
        ``second_stream_noise`` with ``"enc_s"``; the fusion layer's input
        dropout ``fusion_dropout`` from ``"fusion_drop"``; the head's
        ``fusion_output_dropout``. The two encoders run inside the span
        ``mgr.fusion.towers``, the concat and the fusion layer inside
        ``mgr.fusion.layer``."""
        cfg = self.config
        x_a, x_s = inputs
        with tracing.annotate("mgr.fusion.towers"):
            res_a = self._encode("speech", x_a, cfg.encoder.input_noise, train=train,
                                 rng=_sub(rng, "enc_a"))
            res_s = self._encode("skeletal", x_s, cfg.second_stream_noise, train=train,
                                 rng=_sub(rng, "enc_s"))
        with tracing.annotate("mgr.fusion.layer"):
            h = self.fusion(dispatch.local_time(torch.cat([res_a, res_s], dim=-1)),
                            rng=_sub(rng, "fusion_drop"),
                            dropout=cfg.fusion_dropout, train=train,
                            compute_dtype=self.compute_dtype)
        return self._head_apply(h, cfg.fusion_output_dropout, train=train, rng=rng)

    def trainable(self) -> Dict[str, bool]:
        """The grafted encoders train only with ``finetune_encoders``; the
        fusion layer and the head always."""
        enc = bool(self.config.finetune_encoders)
        return {name: enc if name.split(".")[0] in ("speech", "skeletal") else True
                for name, _ in self.named_parameters()}


def build_model(
    cfg: PipelineConfig,
    source_configs: Optional[Dict[str, PipelineConfig]] = None,
    *,
    seed: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> _Model:
    """Model for ``cfg`` with weights drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (default ``cfg.seed``), then
    moved to ``device``: the card by default, as JAX's ``build_model``
    lands on the accelerator; on a host without one this raises, and
    ``device="cpu"`` asks for the plain versions. The draws differ from
    JAX's for the same seed; load weights with ``bridge.load_params`` to
    match a JAX model. Late fusion builds its encoders from
    ``source_configs`` (default: the presets named in
    ``cfg.fusion_sources``)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_model(device={device!r}): no CUDA device on this host; "
                           f"pass device='cpu' for the plain versions")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    if cfg.name in ("speech", "skeletal"):
        model = UnimodalModel(cfg, gen)
    elif cfg.name == "rgb":
        model = RGBModel(cfg, gen)
    elif cfg.name == "early_fusion":
        model = EarlyFusionModel(cfg, gen)
    elif cfg.name == "late_fusion":
        sources = source_configs or {name: get_preset(name) for name in cfg.fusion_sources}
        model = LateFusionModel(cfg, gen, sources)
    else:
        raise KeyError(f"unknown model family {cfg.name!r}")
    return model.to(device).eval()
