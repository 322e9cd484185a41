"""ChaLearn annotation files -> labels (``mgr_tpu/data/labels_pipeline.py``),
on the host.

A ``Sample#####_data_labels.csv`` holds rows of (gesture name, _, start
frame, _, end frame); names map to class ids through
``vocab.GESTURE_NAME_TO_ID``. From them: per-frame label vectors (0 outside
gestures and where an activity mask marks the frame inactive), ordered
class-id sequences, and the ``Id,Sequence`` CSVs every corpus reader takes.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgr_tpu_torch.data.formats import write_label_csv
from mgr_tpu_torch.data.vocab import GESTURE_NAME_TO_ID

Entry = Tuple[str, int, int]  # (gesture name, start frame, end frame)


def parse_label_file(path: str) -> List[Entry]:
    """One annotation file -> [(name, start, end)] in file order. A row
    with four or more numbers is (_, start, _, end); with two or three,
    the first and the last are (start, end)."""
    out: List[Entry] = []
    with open(path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            nums = [int(p) for p in parts[1:] if re.fullmatch(r"-?\d+", p)]
            if len(nums) < 2:
                raise ValueError(f"{path}: bad label row {line!r}")
            start, end = (nums[1], nums[3]) if len(nums) >= 4 else (nums[0], nums[-1])
            out.append((parts[0], start, end))
    return out


def frame_labels(num_frames: int, entries: Sequence[Entry],
                 inactive: Optional[np.ndarray] = None) -> np.ndarray:
    """(T,) int32 class ids: frame f belongs to a gesture when
    start < f <= end; 0 outside gestures, for unknown names and where
    ``inactive`` is set."""
    labs = np.zeros((num_frames,), np.int32)
    for name, start, end in entries:
        cid = GESTURE_NAME_TO_ID.get(name)
        if cid is None:
            continue
        lo, hi = max(start + 1, 0), min(end, num_frames - 1)
        if hi >= lo:
            labs[lo:hi + 1] = cid
    if inactive is not None:
        labs = np.where(inactive[:num_frames].astype(bool), 0, labs)
    return labs


def sequence_labels(entries: Sequence[Entry]) -> List[int]:
    """The class-id sequence in annotation order, unknown names dropped."""
    return [GESTURE_NAME_TO_ID[name] for name, _, _ in entries if name in GESTURE_NAME_TO_ID]


def build_label_csv(label_dir: str, out_csv: str, *,
                    file_pattern: str = r"Sample(\d+)") -> Dict[int, List[int]]:
    """Every ``.csv`` annotation file of ``label_dir`` whose name matches
    ``file_pattern`` -> an ``Id,Sequence`` CSV, in sorted file-name order."""
    labels: Dict[int, List[int]] = {}
    for name in sorted(os.listdir(label_dir)):
        m = re.search(file_pattern, name)
        if not name.endswith(".csv") or not m:
            continue
        labels[int(m.group(1))] = sequence_labels(parse_label_file(os.path.join(label_dir, name)))
    write_label_csv(out_csv, labels)
    return labels
