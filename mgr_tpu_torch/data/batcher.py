"""Batch assembly: split, padding, label preparation
(``mgr_tpu/data/batcher.py``).

Sequences are padded once into static-shape arrays when a corpus is
read; a batch is an array slice.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mgr_tpu_torch.data import vocab as vocab_lib


def reference_split(
    file_list: Sequence, val_split: float, batch_size: int, seed: int = 10,
) -> Tuple[List, List]:
    """The reference's split: ``random.seed(seed); random.shuffle`` with
    the stdlib ``random``, an 80/20 cut, then each side cut down to a
    multiple of ``batch_size``."""
    files = list(file_list)
    rng = random.Random()
    rng.seed(seed)
    rng.shuffle(files)
    split_point = int(len(files) * (1 - val_split))
    train, val = files[:split_point], files[split_point:]
    del train[len(train) - len(train) % batch_size:]
    del val[len(val) - len(val) % batch_size:]
    return train, val


def pad_or_truncate(seq: np.ndarray, maxlen: int) -> Tuple[np.ndarray, int]:
    """Post-pad with zeros / post-truncate to (maxlen, F...); returns the
    true (pre-pad) length."""
    true_len = min(seq.shape[0], maxlen)
    if seq.shape[0] >= maxlen:
        return np.ascontiguousarray(seq[:maxlen]), true_len
    pad = np.zeros((maxlen - seq.shape[0],) + seq.shape[1:], seq.dtype)
    return np.concatenate([seq, pad], axis=0), true_len


def prepare_labels(
    class_seq: Sequence[int], max_label_len: int, blank: int,
    *, expand_words: bool = False,
) -> Tuple[np.ndarray, int]:
    """Class-id sequence -> (-1-padded int32 labels, length).
    ``expand_words`` expands gesture classes to speech words; an empty
    sequence becomes a single blank label."""
    seq = list(class_seq)
    if expand_words:
        seq = vocab_lib.class_seq_to_word_seq(seq)
    if len(seq) == 0:
        seq = [blank]
    seq = seq[:max_label_len]
    out = np.full((max_label_len,), -1, np.int32)
    out[: len(seq)] = np.asarray(seq, np.int32)
    return out, len(seq)


class Batcher:
    """Slices padded (N, T, F) features and their labels into batches of
    the train or validation split. ``features`` may be a pair of such
    arrays (the fusion families' two streams): a batch then carries the
    second as ``inputs2``."""

    def __init__(
        self,
        features: np.ndarray | Tuple[np.ndarray, np.ndarray],
        labels: np.ndarray,
        label_lengths: np.ndarray,
        input_lengths: np.ndarray,
        file_ids: Sequence[int],
        train_ids: Sequence[int],
        val_ids: Sequence[int],
    ):
        self.features = features
        self.labels = labels
        self.label_lengths = label_lengths
        self.input_lengths = input_lengths
        self.file_ids = list(file_ids)
        self._row_of = {fid: i for i, fid in enumerate(self.file_ids)}
        self.train_ids = list(train_ids)
        self.val_ids = list(val_ids)

    def num_batches(self, batch_size: int, train: bool = True) -> int:
        return len(self.train_ids if train else self.val_ids) // batch_size

    def _batch_from_rows(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        batch = {
            "labels": self.labels[rows],
            "input_length": self.input_lengths[rows],
            "label_length": self.label_lengths[rows],
        }
        if isinstance(self.features, tuple):
            batch["inputs"] = self.features[0][rows]
            batch["inputs2"] = self.features[1][rows]
        else:
            batch["inputs"] = self.features[rows]
        return batch

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The whole corpus as the arrays of a batch (``inputs``, and
        ``inputs2`` for two streams, ``labels``, ``input_length``,
        ``label_length``), for ``fit``'s device-resident path: uploaded
        once, gathered on the device by row index."""
        out = {
            "labels": self.labels,
            "input_length": self.input_lengths,
            "label_length": self.label_lengths,
        }
        if isinstance(self.features, tuple):
            out["inputs"], out["inputs2"] = self.features
        else:
            out["inputs"] = self.features
        return out

    def epoch_indices(
        self, batch_size: int, *, train: bool = True,
        shuffle_seed: Optional[int] = None, process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Tuple[List[int], np.ndarray]]:
        """Yields (file_ids, rows) over the split once, rows the (B,) int32
        row indices of the batch in :meth:`device_arrays`; a last partial
        batch is dropped.

        Per-process striding: every process shuffles with the same seed
        and takes batches ``process_index``, ``process_index +
        process_count``, ... of the stream, so the processes read disjoint
        batches that together cover it."""
        ids = list(self.train_ids if train else self.val_ids)
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(ids)
        starts = range(0, len(ids) - batch_size + 1, batch_size)
        for i in starts[process_index::process_count]:
            chunk = ids[i : i + batch_size]
            yield chunk, np.asarray([self._row_of[f] for f in chunk], np.int32)

    def epoch(
        self, batch_size: int, *, train: bool = True,
        shuffle_seed: Optional[int] = None, process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Tuple[List[int], Dict[str, np.ndarray]]]:
        """Yields (file_ids, batch) over the split once: the batches of
        :meth:`epoch_indices` (with its striding), sliced on the host."""
        for chunk, rows in self.epoch_indices(
                batch_size, train=train, shuffle_seed=shuffle_seed,
                process_index=process_index, process_count=process_count):
            yield chunk, self._batch_from_rows(rows)
