"""Pipeline configuration and the five presets
(``mgr_tpu/core/config.py``).

The same frozen dataclasses with the same fields and defaults, so a
``<stamp>_config.json`` written by either package loads in the other
(``PipelineConfig.to_json`` / ``from_json``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: data, model and time axes."""

    data: int = 1
    model: int = 1
    time: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    time_axis: str = "time"

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.time


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam with value clipping, inverse-time decay and max-norm kernels."""

    learning_rate: float = 1e-4
    clipvalue: float = 0.5
    decay: float = 0.0  # Keras `decay`: lr_t = lr / (1 + decay * step)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7
    maxnorm: Optional[float] = 3.0
    accum_steps: int = 1
    skip_nonfinite: int = 0


@dataclass(frozen=True)
class EncoderConfig:
    """Residual BLSTM encoder: GaussianNoise -> BiLSTM x depth ->
    residual add of the last two layers -> dropout."""

    hidden: int = 500
    depth: int = 2
    input_noise: float = 0.5  # GaussianNoise stddev (train only)
    dropout: Tuple[float, ...] = (0.4, 0.5)  # per-layer input dropout
    output_dropout: float = 0.5  # dropout after the residual add
    residual: bool = True
    per_gate_dropout: bool = False


@dataclass(frozen=True)
class CNNConfig:
    """TimeDistributed conv frontend of the RGB stream."""

    channels: Tuple[int, ...] = (16, 32, 48)
    kernel_sizes: Tuple[int, ...] = (5, 5, 4)
    pool_sizes: Tuple[int, ...] = (2, 2, 2)
    img_dim: int = 60
    remat: bool = True


@dataclass(frozen=True)
class CTCConfig:
    """blank = nb_classes - 1; labels padded with -1; the first
    ``trim_frames`` outputs are dropped before the loss and decode, and
    input_length is counted after the trim."""

    trim_frames: int = 2
    # True: CTC runs over the padded length (maxlen - trim) whatever the
    # true length, as the reference does.
    padded_length_parity: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """Everything needed to build one of the five pipelines."""

    name: str = "speech"
    # --- data geometry -------------------------------------------------
    maxlen: int = 1900
    num_feats: int = 39
    nb_classes: int = 44
    max_label_len: int = 150
    downsample: int = 1  # temporal stride applied at featurization
    # --- model ----------------------------------------------------------
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    cnn: Optional[CNNConfig] = None  # RGB only
    ctc: CTCConfig = field(default_factory=CTCConfig)
    fusion_sources: Tuple[str, ...] = ()
    head_blank_bias: float = 0.0  # initial blank-logit bias of the head
    finetune_encoders: bool = False
    fusion_hidden: int = 100
    fusion_dropout: float = 0.5
    fusion_output_dropout: float = 0.5
    second_stream_feats: int = 0
    second_stream_noise: float = 0.0
    # --- training --------------------------------------------------------
    batch_size: int = 32
    epochs: int = 500
    patience: int = 20
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    reduce_lr_factor: Optional[float] = None
    reduce_lr_patience: int = 7
    reduce_lr_min: float = 5e-5
    reduce_lr_min_delta: float = 1e-4
    reduce_lr_cooldown: int = 0
    reduce_lr_monitor: str = "train"
    seed: int = 47  # weight-init seed
    split_seed: int = 10  # train/val split seed
    val_split: float = 0.2
    # --- numerics ---------------------------------------------------------
    compute_dtype: str = "bfloat16"  # matmul dtype; params stay f32
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        return _pipeline_from_dict(json.loads(text))


def _pipeline_from_dict(raw: Dict[str, Any]) -> PipelineConfig:
    raw = dict(raw)
    if raw.get("encoder") is not None:
        enc = dict(raw["encoder"])
        enc["dropout"] = tuple(enc["dropout"])
        raw["encoder"] = EncoderConfig(**enc)
    if raw.get("cnn") is not None:
        cnn = dict(raw["cnn"])
        for k in ("channels", "kernel_sizes", "pool_sizes"):
            cnn[k] = tuple(cnn[k])
        raw["cnn"] = CNNConfig(**cnn)
    if raw.get("ctc") is not None:
        raw["ctc"] = CTCConfig(**raw["ctc"])
    if raw.get("optimizer") is not None:
        raw["optimizer"] = OptimizerConfig(**raw["optimizer"])
    if raw.get("mesh") is not None:
        raw["mesh"] = MeshConfig(**raw["mesh"])
    raw["fusion_sources"] = tuple(raw.get("fusion_sources", ()))
    return PipelineConfig(**raw)


# ---------------------------------------------------------------------------
# Presets: the five reference pipelines.
# ---------------------------------------------------------------------------

def speech() -> PipelineConfig:
    """Word-level speech BLSTM+CTC: 39-d MFCC, x5 temporal downsample,
    BiLSTM(500)x2, 44 word classes."""
    return PipelineConfig(
        name="speech",
        maxlen=1900,
        num_feats=39,
        nb_classes=44,
        max_label_len=150,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.4, 0.5), output_dropout=0.5),
    )


def skeletal() -> PipelineConfig:
    """Skeletal BLSTM+CTC: 20 kinematic feats, BiLSTM(300)x2, 22 gesture
    classes, label cap 28."""
    return PipelineConfig(
        name="skeletal",
        maxlen=1900,
        num_feats=20,
        nb_classes=22,
        max_label_len=28,
        encoder=EncoderConfig(hidden=300, depth=2, input_noise=0.5,
                              dropout=(0.6, 0.6), output_dropout=0.6),
        optimizer=OptimizerConfig(decay=1e-5),
    )


def rgb() -> PipelineConfig:
    """RGB CNN-LSTM: (T, 60, 60, 1) video, 3 conv blocks, BiLSTM(512)x2."""
    return PipelineConfig(
        name="rgb",
        maxlen=1900,
        num_feats=60 * 60,
        nb_classes=22,
        max_label_len=28,
        encoder=EncoderConfig(hidden=512, depth=2, input_noise=0.0,
                              dropout=(0.0, 0.0), output_dropout=0.0),
        cnn=CNNConfig(),
        reduce_lr_factor=0.5,
        reduce_lr_cooldown=2,
        batch_size=8,
    )


def early_fusion() -> PipelineConfig:
    """Early fusion: audio 39 + skeletal 20 on the channel axis ->
    BiLSTM(500)x2, 22 classes, label cap 35."""
    return PipelineConfig(
        name="early_fusion",
        maxlen=1900,
        num_feats=39,
        second_stream_feats=20,
        second_stream_noise=0.5,
        nb_classes=22,
        max_label_len=35,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.4, 0.4), output_dropout=0.4),
    )


def late_fusion() -> PipelineConfig:
    """Late fusion: frozen speech and skeletal encoders -> BiLSTM(100)
    -> Dense(22), label cap 35."""
    return PipelineConfig(
        name="late_fusion",
        maxlen=1900,
        num_feats=39,
        second_stream_feats=20,
        second_stream_noise=0.0,
        nb_classes=22,
        max_label_len=35,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.0, 0.0), output_dropout=0.5),
        fusion_sources=("speech", "skeletal"),
        fusion_hidden=100,
        optimizer=OptimizerConfig(decay=1e-5),
    )


PRESETS = {
    "speech": speech,
    "skeletal": skeletal,
    "rgb": rgb,
    "early_fusion": early_fusion,
    "late_fusion": late_fusion,
}


def get_preset(name: str, **overrides: Any) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown pipeline {name!r}; choose from {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    return cfg.replace(**overrides) if overrides else cfg


def parse_stage_table(raw: str, stage: str, default=None):
    """The per-stage grammar of the learning drivers' environment knobs
    (``mgr_tpu/core/config.py::parse_stage_table``): a bare float applies
    to every stage, ``"name:val,name:val"`` names stages. Returns
    ``default`` when ``raw`` is empty or ``stage`` is absent."""
    if not raw:
        return default
    if ":" not in raw:
        return float(raw)
    for part in raw.split(","):
        name, _, val = part.partition(":")
        if name.strip() == stage and val.strip():
            return float(val)
    return default
