"""Corpus builders: on-disk corpus -> padded arrays in a ``Batcher``
(``mgr_tpu/data/datasets.py``), for the speech and skeletal pipelines.

Modes: ``train`` splits into train/val with the seeded reference split;
``val`` puts every file in the validation list; ``final`` is ``val``
for unlabelled data (blank labels).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mgr_tpu_torch.core.config import PipelineConfig
from mgr_tpu_torch.data import formats
from mgr_tpu_torch.data.batcher import (
    Batcher,
    pad_or_truncate,
    prepare_labels,
    reference_split,
)


def _input_length(cfg: PipelineConfig, true_len: int) -> int:
    """Frames the CTC loss sees: the padded length minus the trim, or
    the true length minus the trim without ``padded_length_parity``."""
    if cfg.ctc.padded_length_parity:
        return cfg.maxlen - cfg.ctc.trim_frames
    return max(min(true_len, cfg.maxlen) - cfg.ctc.trim_frames, 1)


def _split_ids(
    ids: Sequence[int], cfg: PipelineConfig, mode: str
) -> Tuple[List[int], List[int]]:
    if mode == "train":
        return reference_split(ids, cfg.val_split, cfg.batch_size, seed=cfg.split_seed)
    return [], list(ids)


def _assemble(
    cfg: PipelineConfig,
    ids: Sequence[int],
    feats_of: Dict[int, np.ndarray],
    labels_map: Dict[int, List[int]],
    *,
    expand_words: bool,
    mode: str,
) -> Batcher:
    N = len(ids)
    F = next(iter(feats_of.values())).shape[-1]
    X = np.zeros((N, cfg.maxlen, F), np.float32)
    labels = np.zeros((N, cfg.max_label_len), np.int32)
    lab_len = np.zeros((N,), np.int32)
    in_len = np.zeros((N,), np.int32)
    blank = cfg.nb_classes - 1
    for i, fid in enumerate(ids):
        x = feats_of[fid]
        if cfg.downsample > 1:
            x = x[:: cfg.downsample]
        X[i], true_len = pad_or_truncate(x, cfg.maxlen)
        seq = [] if mode == "final" else labels_map.get(fid, [])
        labels[i], lab_len[i] = prepare_labels(
            seq, cfg.max_label_len, blank, expand_words=expand_words
        )
        in_len[i] = _input_length(cfg, true_len)
    train_ids, val_ids = _split_ids(ids, cfg, mode)
    return Batcher(X, labels, lab_len, in_len, ids, train_ids, val_ids)


def build_audio_dataset(
    data_dir: str, label_file: str, cfg: PipelineConfig, mode: str = "train",
) -> Batcher:
    """Speech: per-file audio CSVs, labels expanded from gesture classes
    to words."""
    ids = formats.list_audio_files(data_dir)
    feats = {
        fid: formats.load_audio_file_csv(os.path.join(data_dir, f"audio_{fid}.csv"))
        for fid in ids
    }
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    return _assemble(cfg, ids, feats, labels_map, expand_words=True, mode=mode)


def build_skeletal_dataset(
    skeletal_csv: str, label_file: str, cfg: PipelineConfig, mode: str = "train",
) -> Batcher:
    """Skeletal: the monolithic z-scored CSV, class-id labels; files in
    order of first appearance."""
    feats = formats.load_skeletal_csv(skeletal_csv, normalize=True)
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    return _assemble(cfg, list(feats), feats, labels_map, expand_words=False, mode=mode)
