"""Raw Kinect CSVs -> the monolithic skeletal feature CSV
(``mgr_tpu/data/skeletal_pipeline.py``): the reference's three offline
stages (activity features, gather with the train/val split at a file id,
kinematics) as one pass a video.

A raw per-video CSV has a header row and one column per joint holding
"[x y]" strings (hip_center, shoulder_center, left/right shoulder, elbow,
wrist and hand); out-of-range coordinates snap to the frame centre
(x >= 640 -> 320, y >= 480 -> 240). The cells are parsed on the host with
the ``csv`` module; the features (``ops/kinematics.py``) are computed on
the ``device`` given.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mgr_tpu_torch.data.formats import SKELETAL_FEATURES
from mgr_tpu_torch.ops.kinematics import skeletal_features

# Raw CSV column name -> short joint key.
KINECT_COLUMNS = {
    "hip_center": "hip",
    "shoulder_center": "shc",
    "left_shoulder": "ls",
    "left_elbow": "le",
    "left_wrist": "lw",
    "left_hand": "lh",
    "right_shoulder": "rs",
    "right_elbow": "re",
    "right_wrist": "rw",
    "right_hand": "rh",
}

_PAIR_RE = re.compile(r"\[?\s*(-?\d+)\s+(-?\d+)\s*\]?")

SKELETAL_HEADER = ",".join(SKELETAL_FEATURES) + ",file_number"


def _parse_pair_column(values: Sequence[str]) -> np.ndarray:
    """Column of "[x y]" strings -> (T, 2) float32 with the Kinect
    clipping."""
    out = np.zeros((len(values), 2), np.float32)
    for i, v in enumerate(values):
        m = _PAIR_RE.search(str(v))
        if not m:
            raise ValueError(f"unparseable joint cell {v!r}")
        x, y = int(m.group(1)), int(m.group(2))
        if x >= 640:
            x = 320
        if y >= 480:
            y = 240
        out[i] = (x, y)
    return out


def parse_kinect_csv(path: str) -> Dict[str, np.ndarray]:
    """Raw per-video CSV -> {joint: (T, 2)} tracks, the columns read by
    header name. A CSV without frames is refused (the JAX package's
    kinematics fail on it, and its pipeline skips the video)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{path}: no frames")
    return {key: _parse_pair_column([row[col] for row in rows])
            for col, key in KINECT_COLUMNS.items()}


def video_features(joints: Dict[str, np.ndarray], *,
                   device: torch.device | str = "cuda") -> np.ndarray:
    """One video's (T, 20) model features (``formats.SKELETAL_FEATURES``
    order), computed on ``device``."""
    on_dev = {k: torch.from_numpy(v).to(device) for k, v in joints.items()}
    return skeletal_features(on_dev).cpu().numpy()


def _write(path: str, rows: List[np.ndarray]) -> None:
    np.savetxt(path, np.concatenate(rows, axis=0), delimiter=",",
               header=SKELETAL_HEADER, comments="", fmt="%.6f")


def extract_directory(raw_dir: str, out_csv: str, *, file_pattern: str = r"Sample(\d+)",
                      split_at: Optional[int] = None, val_csv: Optional[str] = None,
                      device: torch.device | str = "cuda") -> List[int]:
    """Every raw Kinect CSV of ``raw_dir`` (sorted by name) -> the
    monolithic feature CSV(s); returns the ids featurized.

    With ``split_at`` (the reference splits at file id 403), ids below it
    go to ``out_csv`` and the rest to ``val_csv``. A video whose skeleton
    fails to parse is skipped, with a line saying so, as the reference
    skips it."""
    rows_train: List[np.ndarray] = []
    rows_val: List[np.ndarray] = []
    ids: List[int] = []
    for name in sorted(os.listdir(raw_dir)):
        m = re.search(file_pattern, name)
        if not name.endswith(".csv") or not m:
            continue
        fid = int(m.group(1))
        try:
            feats = video_features(parse_kinect_csv(os.path.join(raw_dir, name)),
                                   device=device)
        except (ValueError, KeyError) as e:
            print(f"skipping {name}: {type(e).__name__}: {e}")
            continue
        row = np.concatenate([feats, np.full((feats.shape[0], 1), fid, np.float32)], axis=1)
        (rows_val if split_at is not None and fid >= split_at else rows_train).append(row)
        ids.append(fid)
    if rows_train:
        _write(out_csv, rows_train)
    if split_at is not None and val_csv and rows_val:
        _write(val_csv, rows_val)
    return ids
