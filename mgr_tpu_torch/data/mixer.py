"""Dataset mixer (``mgr_tpu/data/mixer.py``), on the host with the ``csv``
module in place of pandas.

Moves a seeded sample of validation files into the training set, the same
files in the audio, skeletal and label streams, and explodes monolithic
audio CSVs into the per-file ``audio_<id>.csv`` layout the loaders read.
The sample is ``random.Random(seed).sample`` of index positions, sorted
(Python 3's draw; the reference ran Python 2's, which differs).

Rows are copied as the input holds them, in the order pandas' ``concat``
and ``loc`` give (the training rows, then the moved rows in file order);
the header and the column order are kept. pandas would rewrite a number
(``403.000000`` as ``403.0``): the bytes may differ, what they parse to
does not.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, Iterable, List, Sequence, Tuple

Table = Tuple[List[str], List[List[str]]]  # header, rows


def _read(path: str) -> Table:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [row for row in reader if row]


def _write(path: str, header: List[str], rows: Iterable[List[str]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def _ids(table: Table, id_col: str) -> List[float]:
    """The id column as numbers, one per row."""
    header, rows = table
    col = header.index(id_col)
    return [float(row[col]) for row in rows]


def _split(table: Table, id_col: str, moved: Sequence[int]) -> Tuple[list, list]:
    """(rows whose id is in ``moved``, the other rows), each in file order."""
    wanted = {float(x) for x in moved}
    hit, rest = [], []
    for row, fid in zip(table[1], _ids(table, id_col)):
        (hit if fid in wanted else rest).append(row)
    return hit, rest


def _unique_ids(path: str, id_col: str = "file_number") -> List[int]:
    """The file ids of a CSV in order of first appearance."""
    return [int(x) for x in dict.fromkeys(_ids(_read(path), id_col))]


def sample_validation_files(val_file_list: Sequence[int], n_moved: int = 95,
                            seed: int = 10) -> Tuple[List[int], List[int]]:
    """Pick ``n_moved`` validation files to move into training; returns
    (moved, kept), ``kept`` sorted."""
    rng = random.Random(seed)
    n = len(val_file_list)
    idx = sorted(rng.sample(range(n), min(n_moved, n)))
    moved = [val_file_list[i] for i in idx]
    return moved, sorted(set(val_file_list) - set(moved))


def mix_frame_datasets(train_csv: str, val_csv: str, moved: Sequence[int], out_train: str,
                       out_val: str, id_col: str = "file_number") -> None:
    """Move the rows of the ``moved`` file ids from the validation CSV into
    the training CSV, writing the two new sets."""
    header, train_rows = _read(train_csv)
    val = _read(val_csv)
    hit, rest = _split(val, id_col, moved)
    _write(out_train, header, train_rows + hit)
    _write(out_val, val[0], rest)


def mix_label_csvs(train_labels_csv: str, val_labels_csv: str, moved: Sequence[int],
                   out_train: str, out_val: str) -> None:
    """The same move for the ``Id,Sequence`` label CSVs."""
    mix_frame_datasets(train_labels_csv, val_labels_csv, moved, out_train, out_val, "Id")


def explode_audio_csv(monolithic_csv: str, out_dir: str,
                      file_list: Sequence[int] | None = None) -> List[int]:
    """A monolithic audio CSV -> one ``audio_<id>.csv`` per file id of
    ``file_list`` (default: every id, in order of first appearance);
    returns the ids written."""
    os.makedirs(out_dir, exist_ok=True)
    table = _read(monolithic_csv)
    by_id: Dict[float, list] = {}
    for row, fid in zip(table[1], _ids(table, "file_number")):
        by_id.setdefault(fid, []).append(row)
    ids = list(file_list) if file_list is not None else [int(x) for x in by_id]
    for fid in ids:
        _write(os.path.join(out_dir, f"audio_{fid}.csv"), table[0], by_id.get(float(fid), []))
    return ids


def mix_all(*, audio_train_csv: str, audio_val_csv: str, skeletal_train_csv: str,
            skeletal_val_csv: str, train_labels_csv: str, val_labels_csv: str, out_root: str,
            n_moved: int = 95, seed: int = 10) -> Dict[str, object]:
    """Sample ``n_moved`` validation files and merge them into training
    across the labels, the audio and the skeletal stream; the per-file
    audio goes to ``out_root/train_audio`` and ``out_root/val_audio``."""
    os.makedirs(out_root, exist_ok=True)
    moved, kept = sample_validation_files(_unique_ids(audio_val_csv), n_moved, seed)
    mix_label_csvs(train_labels_csv, val_labels_csv, moved,
                   os.path.join(out_root, "training.csv"),
                   os.path.join(out_root, "validation.csv"))
    train_ids = _unique_ids(audio_train_csv)
    train_dir = os.path.join(out_root, "train_audio")
    explode_audio_csv(audio_train_csv, train_dir, train_ids)
    explode_audio_csv(audio_val_csv, train_dir, moved)
    explode_audio_csv(audio_val_csv, os.path.join(out_root, "val_audio"), kept)
    mix_frame_datasets(skeletal_train_csv, skeletal_val_csv, moved,
                       os.path.join(out_root, "Training_set_skeletal.csv"),
                       os.path.join(out_root, "Validation_set_skeletal.csv"))
    return {"moved": moved, "kept": kept, "train_ids": train_ids}
