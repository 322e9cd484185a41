"""Readers of the on-disk corpus formats (``mgr_tpu/data/formats.py``),
with the standard ``csv`` module and numpy in place of pandas:

  * per-file audio CSVs ``audio_<id>.csv``: a header row; 39 MFCC
    columns, plus ``file_number`` and optionally '39'/'40', which are
    dropped. Parsed by the C++ reader ``native/fastcsv.cpp``.
  * the monolithic labelled audio CSV (early fusion): no header; columns
    0-38 the features, 39 the file number, 40 the frame's label.
  * the monolithic skeletal CSV: a header; the 20 kinematic feature
    columns by name and ``file_number``.
  * label CSVs: header ``Id,Sequence``, Sequence a space-separated
    class-id string.
  * per-video frames ``Sample#####_color.npy``: (T, H, W) or (T, H, W, 1)
    pixels.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from mgr_tpu_torch.data import fastcsv

# The 20 model features, in the order the reference selects them.
SKELETAL_FEATURES: Tuple[str, ...] = (
    "lh_v", "rh_v", "le_v", "re_v", "lh_dist_rp", "rh_dist_rp",
    "lh_hip_d", "rh_hip_d", "le_hip_d", "re_hip_d", "lh_shc_d", "rh_shc_d",
    "le_shc_d", "re_shc_d", "lh_hip_ang", "rh_hip_ang", "lh_shc_ang",
    "rh_shc_ang", "lh_el_ang", "rh_el_ang",
)

NUM_AUDIO_FEATS = 39


def _header(path: str | os.PathLike) -> List[str]:
    with open(path, newline="") as f:
        return next(csv.reader(f))


def zscore(x: np.ndarray) -> np.ndarray:
    """Column-wise zero mean, unit population variance (a constant column
    is only centred)."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (x - mean) / std


def load_label_csv(path: str | os.PathLike) -> Dict[int, List[int]]:
    """``Id,Sequence`` -> {file_id: [class ids]}; an empty Sequence maps
    to []."""
    with open(path, newline="") as f:
        return {
            int(row["Id"]): [int(x) for x in (row["Sequence"] or "").split()]
            for row in csv.DictReader(f)
        }


def write_label_csv(path: str | os.PathLike, labels: Dict[int, List[int]]) -> None:
    """{file_id: [class ids]} -> ``Id,Sequence`` in the dict's order (a copy
    of ``mgr_tpu/data/synthetic.py::write_label_csv``)."""
    with open(path, "w") as f:
        f.write("Id,Sequence\n")
        for fid, seq in labels.items():
            f.write(f"{fid},{' '.join(str(x) for x in seq)}\n")


def list_audio_files(data_dir: str | os.PathLike) -> List[int]:
    """Sorted numeric ids of the ``audio_<id>.csv`` files."""
    ids = []
    for name in os.listdir(data_dir):
        m = re.findall(r"audio_(\d+)\.csv", name)
        if m:
            ids.append(int(m[0]))
    return sorted(ids)


def load_audio_file_csv(path: str | os.PathLike) -> np.ndarray:
    """One per-file audio CSV -> (T, 39) float32 features, each cell
    parsed by ``strtof`` (``data/fastcsv.py``), as the JAX package parses
    it."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    keep = [i for i, name in enumerate(header)
            if name not in ("file_number", "39", "40")]
    x = np.ascontiguousarray(
        fastcsv.load_numeric_csv(str(path), skip_header=True)[:, keep], dtype=np.float32)
    if x.shape[1] != NUM_AUDIO_FEATS:
        raise ValueError(
            f"{path}: expected {NUM_AUDIO_FEATS} feature cols, got {x.shape[1]}"
        )
    return x


def _by_file(file_nums: np.ndarray) -> List[int]:
    """File numbers in order of first appearance, once each."""
    return [int(fid) for fid in dict.fromkeys(file_nums.tolist())]


def load_monolithic_audio_csv(
    path: str | os.PathLike, normalize: bool = True
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Headerless labelled audio CSV -> {file_id: (feats (T, 39) float32,
    frame labels (T,) int32)} in order of first appearance, the features
    z-scored over the whole corpus before the split by file."""
    table = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    # Column-major, as a pandas frame's block: the z-score then sums each
    # column in the same order.
    feats = np.asfortranarray(table[:, :NUM_AUDIO_FEATS], dtype=np.float32)
    if normalize:
        feats = zscore(feats)
    file_nums = table[:, NUM_AUDIO_FEATS].astype(np.int64)
    frame_labels = table[:, NUM_AUDIO_FEATS + 1].astype(np.int32)
    return {fid: (feats[file_nums == fid], frame_labels[file_nums == fid])
            for fid in _by_file(file_nums)}


def load_skeletal_csv(
    path: str | os.PathLike, normalize: bool = True
) -> Dict[int, np.ndarray]:
    """Monolithic skeletal CSV -> {file_id: (T, 20) float32} in order of
    first appearance, z-scored over the whole corpus first."""
    col = {name: i for i, name in enumerate(_header(path))}
    cols = [col[name] for name in SKELETAL_FEATURES] + [col["file_number"]]
    table = np.loadtxt(path, delimiter=",", skiprows=1, usecols=cols,
                       dtype=np.float64, ndmin=2)
    feats = table[:, :-1].astype(np.float32)
    if normalize:
        feats = zscore(feats)
    file_nums = table[:, -1].astype(np.int64)
    return {fid: feats[file_nums == fid] for fid in _by_file(file_nums)}


def list_video_files(data_dir: str | os.PathLike) -> List[str]:
    """The ``.npy`` file names of ``data_dir``, string-sorted."""
    return sorted(n for n in os.listdir(data_dir) if n.endswith(".npy"))


def video_file_id(name: str) -> int:
    """``Sample00007_color.npy`` -> 7 (characters 6-10 of the name)."""
    return int(name[6:11])


def load_video_npy(path: str | os.PathLike) -> np.ndarray:
    """One video -> (T, H, W, 1) float32 frames (a 3-D array gets the
    channel axis)."""
    x = np.load(path).astype(np.float32)
    if x.ndim == 3:
        x = x[..., None]
    return x
