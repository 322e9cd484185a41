"""Synthetic ChaLearn-format fixtures for tests and benchmarks
(``mgr_tpu/data/synthetic.py``: the same arguments write the same bytes).

Writes tiny datasets in the reference's exact on-disk layout (per-file
audio CSVs, monolithic skeletal/audio CSVs, Id/Sequence label files,
per-video .npy) so the loaders, trainers, and decoders can be exercised
end-to-end without the real 10 GB dataset.

The generated sequences are learnable on purpose: each gesture class
shifts the feature distribution, so a few training steps visibly drop
the CTC loss in smoke tests.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgr_tpu_torch.data.formats import SKELETAL_FEATURES, write_label_csv

__all__ = ["make_audio_dataset", "make_skeletal_dataset", "make_monolithic_audio_dataset",
           "make_rgb_dataset", "write_label_csv"]


def _label_sequences(
    rng: np.random.Generator, n_files: int, n_classes: int,
    max_labels: int, min_labels: int = 1,
) -> Dict[int, List[int]]:
    # min_labels raises the content density floor: ChaLearn files carry
    # 8-20 gestures, and sparse files (k=1 at a 1900-frame window is
    # ~95% padding) pin skeletal/fusion CTC stacks in the all-blank basin.
    min_labels = max(1, min(min_labels, max_labels))
    out = {}
    for fid in range(1, n_files + 1):
        k = int(rng.integers(min_labels, max_labels + 1))
        out[fid] = rng.integers(1, n_classes - 1, size=k).tolist()
    return out


def _reuse_sentinel(out_dir: str, tag: str, params: Dict) -> Tuple[str, bool]:
    """Sentinel for idempotent regeneration (``reuse=True``): the
    generators are seed-deterministic, so a completed prior run with the
    same parameters left identical bytes on disk. Returns
    (sentinel_path, hit). The sentinel's name is the JAX package's, so
    either package's completed run is reused by the other."""
    key = hashlib.md5(
        json.dumps(params, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f".{tag}-{key}.complete")
    return path, os.path.exists(path)


def _class_signature(c: int, F: int) -> np.ndarray:
    """Deterministic per-class mean vector. Every class gets a DISTINCT
    signature (seeded by the class id), so the corpus is genuinely
    separable: a correct model can both memorize the train split and
    generalize to unseen files. (An earlier scalar `(c % 7) - 3` made
    classes collide mod 7 — unlearnable except by memorization, which
    capped what e2e learning tests could assert.)"""
    return np.random.default_rng(10_000 + c).uniform(
        -2.5, 2.5, size=F
    ).astype(np.float32)


def _class_signal(
    rng: np.random.Generator, seq: Sequence[int], frames_per: int, F: int
) -> np.ndarray:
    """Per-class mean-shifted noise blocks, one block per label."""
    blocks = []
    for c in seq:
        blocks.append(
            (_class_signature(int(c), F)
             + rng.normal(0.0, 1.0, size=(frames_per, F))).astype(np.float32)
        )
    return np.concatenate(blocks, axis=0)


def make_audio_dataset(
    out_dir: str,
    *,
    n_files: int = 8,
    n_classes: int = 22,
    frames_per_label: int = 60,
    max_labels: int = 3,
    seed: int = 0,
    labels: Optional[Dict[int, List[int]]] = None,
    reuse: bool = False,
    min_labels: int = 1,
) -> Tuple[str, str, Dict[int, List[int]]]:
    """Per-file ``audio_<id>.csv`` (39 feats + file_number col) and a
    ``training_oov.csv`` label file. Returns (data_dir, label_file,
    labels). Pass ``labels`` to reuse another stream's sequences (fusion
    corpora: both modalities encode the SAME gestures per file id).
    ``reuse=True`` skips regeneration when a prior identical run
    completed in the same out_dir."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(out_dir, "train_audio")
    os.makedirs(data_dir, exist_ok=True)
    if labels is None:
        labels = _label_sequences(rng, n_files, n_classes, max_labels,
                                  min_labels)
    sent, hit = (None, False)
    if reuse:
        sent, hit = _reuse_sentinel(out_dir, "audio", dict(
            n=n_files, c=n_classes, fpl=frames_per_label, ml=max_labels,
            seed=seed, labels=sorted(labels.items()),
        ))
    label_file = os.path.join(out_dir, "training_oov.csv")
    if not hit:
        header = ",".join(str(i) for i in range(39)) + ",file_number"
        for fid, seq in labels.items():
            x = _class_signal(rng, seq, frames_per_label, 39)
            rows = np.concatenate(
                [x, np.full((x.shape[0], 1), fid, np.float32)], axis=1
            )
            np.savetxt(
                os.path.join(data_dir, f"audio_{fid}.csv"),
                rows, delimiter=",", header=header, comments="", fmt="%.5f",
            )
        write_label_csv(label_file, labels)
        if sent:
            with open(sent, "w") as f:
                f.write("ok\n")
    return data_dir, label_file, labels


def make_skeletal_dataset(
    out_dir: str,
    *,
    n_files: int = 8,
    n_classes: int = 22,
    frames_per_label: int = 40,
    max_labels: int = 3,
    seed: int = 1,
    reuse: bool = False,
    min_labels: int = 1,
) -> Tuple[str, str, Dict[int, List[int]]]:
    """Monolithic ``Training_set_skeletal.csv`` (20 feats + file_number)
    and a ``training.csv`` label file."""
    rng = np.random.default_rng(seed)
    labels = _label_sequences(rng, n_files, n_classes, max_labels,
                              min_labels)
    csv_path = os.path.join(out_dir, "Training_set_skeletal.csv")
    label_file = os.path.join(out_dir, "training.csv")
    sent, hit = (None, False)
    if reuse:
        sent, hit = _reuse_sentinel(out_dir, "skeletal", dict(
            n=n_files, c=n_classes, fpl=frames_per_label, ml=max_labels,
            mn=min_labels, seed=seed,
        ))
    if not hit:
        rows = []
        for fid, seq in labels.items():
            x = _class_signal(rng, seq, frames_per_label,
                              len(SKELETAL_FEATURES))
            fcol = np.full((x.shape[0], 1), fid, np.float32)
            rows.append(np.concatenate([x, fcol], axis=1))
        all_rows = np.concatenate(rows, axis=0)
        header = ",".join(SKELETAL_FEATURES) + ",file_number"
        np.savetxt(csv_path, all_rows, delimiter=",", header=header,
                   comments="", fmt="%.5f")
        write_label_csv(label_file, labels)
        if sent:
            with open(sent, "w") as f:
                f.write("ok\n")
    return csv_path, label_file, labels


def make_monolithic_audio_dataset(
    out_dir: str,
    labels: Dict[int, List[int]],
    *,
    frames_per_label: int = 300,  # pre-downsample: x5 of the skeletal rate
    seed: int = 2,
    reuse: bool = False,
) -> str:
    """Headerless labeled audio CSV for the early-fusion pipeline:
    cols 0-38 feats, col 39 file id, col 40 per-frame class label."""
    rng = np.random.default_rng(seed)
    path = os.path.join(out_dir, "Training_set_audio_labeled.csv")
    sent, hit = (None, False)
    if reuse:
        sent, hit = _reuse_sentinel(out_dir, "mono_audio", dict(
            fpl=frames_per_label, seed=seed,
            labels=sorted(labels.items()),
        ))
    if hit:
        return path
    rows = []
    for fid, seq in labels.items():
        x = _class_signal(rng, seq, frames_per_label, 39)
        frame_labels = np.repeat(
            np.asarray(seq, np.float32), frames_per_label
        )[:, None]
        fcol = np.full((x.shape[0], 1), fid, np.float32)
        rows.append(np.concatenate([x, fcol, frame_labels], axis=1))
    all_rows = np.concatenate(rows, axis=0)
    np.savetxt(path, all_rows, delimiter=",", fmt="%.5f")
    if sent:
        with open(sent, "w") as f:
            f.write("ok\n")
    return path


def make_rgb_dataset(
    out_dir: str,
    *,
    n_files: int = 4,
    n_classes: int = 22,
    frames_per_label: int = 10,
    max_labels: int = 2,
    img_dim: int = 60,
    seed: int = 3,
    reuse: bool = False,
) -> Tuple[str, str, Dict[int, List[int]]]:
    """Per-video ``Sample#####_color.npy`` (T, D, D, 1) + labels.

    Frames are class-SEPARABLE: each class renders a deterministic 8x8
    spatial pattern (upsampled to the frame) plus pixel noise, so a
    correct CNN-LSTM can actually learn the corpus — pure uniform noise
    (the original generator) admits no better-than-chance model."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(out_dir, "training_up_body")
    os.makedirs(data_dir, exist_ok=True)
    labels = _label_sequences(rng, n_files, n_classes, max_labels)
    sent, hit = (None, False)
    if reuse:
        sent, hit = _reuse_sentinel(out_dir, "rgb", dict(
            n=n_files, c=n_classes, fpl=frames_per_label, ml=max_labels,
            img=img_dim, seed=seed,
        ))
    if hit:
        return data_dir, os.path.join(out_dir, "rgb_training.csv"), labels
    rep = img_dim // 8 + 1
    for fid, seq in labels.items():
        frames = []
        for c in seq:
            pat = _class_signature(int(c), 64).reshape(8, 8)
            img = np.kron(pat, np.ones((rep, rep)))[:img_dim, :img_dim]
            block = (
                128.0 + 24.0 * img[None, :, :]
                + rng.normal(0.0, 8.0, size=(frames_per_label, img_dim, img_dim))
            )
            frames.append(block)
        video = np.clip(np.concatenate(frames, axis=0), 0, 255)[
            ..., None
        ].astype(np.uint8)
        np.save(os.path.join(data_dir, f"Sample{fid:05d}_color.npy"), video)
    label_file = os.path.join(out_dir, "rgb_training.csv")
    write_label_csv(label_file, labels)
    if sent:
        with open(sent, "w") as f:
            f.write("ok\n")
    return data_dir, label_file, labels
