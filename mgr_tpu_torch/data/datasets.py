"""Corpus builders: on-disk corpus -> padded arrays in a ``Batcher``
(``mgr_tpu/data/datasets.py``), for the speech, skeletal, early-fusion and
late-fusion pipelines. A fusion corpus holds two streams, audio then
skeletal, padded to the same length. The rgb corpus is too large to hold
(27 MB a video at T=1900): its ``LazyVideoBatcher`` loads each batch's
videos when the batch is due, on a worker thread.

Modes: ``train`` splits into train/val with the seeded reference split;
``val`` puts every file in the validation list; ``final`` is ``val``
for unlabelled data (blank labels).
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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
    second_feats_of: Optional[Dict[int, np.ndarray]] = None,
) -> Batcher:
    """Pads every file into (N, maxlen, F) arrays; ``second_feats_of`` adds
    a second stream, padded alike (never downsampled). The input length
    comes from the first stream's true length."""
    N = len(ids)
    F = next(iter(feats_of.values())).shape[-1]
    X = np.zeros((N, cfg.maxlen, F), np.float32)
    X2 = None
    if second_feats_of is not None:
        F2 = next(iter(second_feats_of.values())).shape[-1]
        X2 = np.zeros((N, cfg.maxlen, F2), np.float32)
    labels = np.zeros((N, cfg.max_label_len), np.int32)
    lab_len = np.zeros((N,), np.int32)
    in_len = np.zeros((N,), np.int32)
    blank = cfg.nb_classes - 1
    for i, fid in enumerate(ids):
        x = feats_of[fid]
        if cfg.downsample > 1:
            x = x[:: cfg.downsample]
        X[i], true_len = pad_or_truncate(x, cfg.maxlen)
        if X2 is not None:
            X2[i], _ = pad_or_truncate(second_feats_of[fid], cfg.maxlen)
        seq = [] if mode == "final" else labels_map.get(fid, [])
        labels[i], lab_len[i] = prepare_labels(
            seq, cfg.max_label_len, blank, expand_words=expand_words
        )
        in_len[i] = _input_length(cfg, true_len)
    train_ids, val_ids = _split_ids(ids, cfg, mode)
    features = (X, X2) if X2 is not None else X
    return Batcher(features, labels, lab_len, in_len, ids, train_ids, val_ids)


def _corpus_cache_key(paths: List[str], cfg: PipelineConfig, mode: str) -> str:
    """The key of a corpus cache (``mgr_tpu/data/datasets.py``, the same
    bytes hashed): each file's path, mtime and size, and the geometry
    that shapes the arrays."""
    h = hashlib.sha1()
    for p in sorted(paths):
        st = os.stat(p)
        h.update(f"{p}:{st.st_mtime_ns}:{st.st_size};".encode())
    h.update(
        f"{cfg.maxlen}:{cfg.downsample}:{cfg.max_label_len}:"
        f"{cfg.nb_classes}:{cfg.ctc.trim_frames}:"
        f"{cfg.ctc.padded_length_parity}:{mode}".encode()
    )
    return h.hexdigest()[:20]


def build_audio_dataset(
    data_dir: str, label_file: str, cfg: PipelineConfig, mode: str = "train",
    cache_dir: Optional[str] = None,
) -> Batcher:
    """Speech: per-file audio CSVs, labels expanded from gesture classes
    to words.

    ``cache_dir`` keeps the padded arrays in one ``audio_<key>.npz``
    (arrays ``X``, ``labels``, ``lab_len``, ``in_len``) keyed by
    :func:`_corpus_cache_key`, as the JAX package does: a later build of
    the same files and geometry reads it instead of the CSVs, and either
    package reads the other's cache."""
    ids = formats.list_audio_files(data_dir)
    paths = [os.path.join(data_dir, f"audio_{fid}.csv") for fid in ids]
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        key = _corpus_cache_key(paths + [label_file], cfg, mode)
        cache_path = os.path.join(cache_dir, f"audio_{key}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                arrays = z["X"], z["labels"], z["lab_len"], z["in_len"]
            return Batcher(*arrays, ids, *_split_ids(ids, cfg, mode))
    feats = {fid: formats.load_audio_file_csv(path) for fid, path in zip(ids, paths)}
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    b = _assemble(cfg, ids, feats, labels_map, expand_words=True, mode=mode)
    if cache_path is not None:
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, X=b.features, labels=b.labels, lab_len=b.label_lengths,
                 in_len=b.input_lengths)
        os.replace(tmp, cache_path)
    return b


def build_skeletal_dataset(
    skeletal_csv: str, label_file: str, cfg: PipelineConfig, mode: str = "train",
) -> Batcher:
    """Skeletal: the monolithic z-scored CSV, class-id labels; files in
    order of first appearance."""
    feats = formats.load_skeletal_csv(skeletal_csv, normalize=True)
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    return _assemble(cfg, list(feats), feats, labels_map, expand_words=False, mode=mode)


def build_early_fusion_dataset(
    audio_csv: str, skeletal_csv: str, cfg: PipelineConfig, mode: str = "train",
) -> Batcher:
    """Early fusion: the monolithic labelled audio CSV (z-scored,
    downsampled by ``cfg.downsample``) and the z-scored skeletal CSV, over
    the files both hold, in the audio CSV's order. A file's labels are its
    non-zero frame labels, each once, in order of first appearance."""
    audio = formats.load_monolithic_audio_csv(audio_csv, normalize=True)
    skel = formats.load_skeletal_csv(skeletal_csv, normalize=True)
    ids = [fid for fid in audio if fid in skel]
    labels_map = {
        fid: list(dict.fromkeys(int(v) for v in audio[fid][1] if v != 0)) for fid in ids
    }
    return _fusion(cfg, ids, {fid: audio[fid][0] for fid in ids}, skel, labels_map, mode)


def build_late_fusion_dataset(
    audio_dir: str, skeletal_csv: str, label_file: str, cfg: PipelineConfig,
    mode: str = "train",
) -> Batcher:
    """Late fusion: the per-file audio CSVs (downsampled by
    ``cfg.downsample``, NOT normalized) and the z-scored skeletal CSV, over
    the files both hold, in sorted audio id order; class-id labels."""
    skel = formats.load_skeletal_csv(skeletal_csv, normalize=True)
    ids = [fid for fid in formats.list_audio_files(audio_dir) if fid in skel]
    feats = {
        fid: formats.load_audio_file_csv(os.path.join(audio_dir, f"audio_{fid}.csv"))
        for fid in ids
    }
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    return _fusion(cfg, ids, feats, skel, labels_map, mode)


def _fusion(cfg: PipelineConfig, ids: List[int], audio: Dict[int, np.ndarray],
            skel: Dict[int, np.ndarray], labels_map: Dict[int, List[int]],
            mode: str) -> Batcher:
    """The two streams assembled: the audio downsampled here, then
    ``_assemble`` with ``downsample=1`` so that the skeletal stream (already
    at the audio's downsampled rate) is left as it is."""
    audio = {fid: x[:: cfg.downsample] for fid, x in audio.items()}
    return _assemble(cfg.replace(downsample=1), ids, audio, labels_map,
                     expand_words=False, mode=mode, second_feats_of=skel)


PREFETCH = 2  # video batches loaded ahead of the one in use


class LazyVideoBatcher(Batcher):
    """Batches of per-video ``.npy`` frames, loaded and padded when due
    (``mgr_tpu/data/datasets.py:229-293``): the labels and lengths are held,
    the frames are not. A batch's inputs are (B, maxlen, D, D, 1) f32,
    normalised as ``(x - 128) / 255`` after the padding, so a padded frame
    is -128/255 as in JAX."""

    def __init__(self, data_dir: str, names: List[str], cfg: PipelineConfig,
                 labels: np.ndarray, lab_len: np.ndarray, in_len: np.ndarray,
                 ids: Sequence[int], train_ids: Sequence[int], val_ids: Sequence[int]):
        super().__init__(None, labels, lab_len, in_len, ids, train_ids, val_ids)
        self.data_dir = data_dir
        self.cfg = cfg
        self._name_of = dict(zip(ids, names))

    def _load_batch(self, chunk: List[int]) -> Tuple[List[int], Dict[str, np.ndarray]]:
        cfg = self.cfg
        D = cfg.cnn.img_dim
        X = np.zeros((len(chunk), cfg.maxlen, D, D, 1), np.float32)
        for j, fid in enumerate(chunk):
            x = formats.load_video_npy(os.path.join(self.data_dir, self._name_of[fid]))
            X[j, : min(len(x), cfg.maxlen)] = x[: cfg.maxlen]
        # In place, with the same f32 operations as JAX's (X - 128.0) / 255.0.
        X -= 128.0
        X /= 255.0
        rows = [self._row_of[f] for f in chunk]
        return chunk, {
            "inputs": X,
            "labels": self.labels[rows],
            "input_length": self.input_lengths[rows],
            "label_length": self.label_lengths[rows],
        }

    def epoch(
        self, batch_size: int, *, train: bool = True, shuffle_seed: Optional[int] = None,
        process_index: int = 0, process_count: int = 1,
    ) -> Iterator[Tuple[List[int], Dict[str, np.ndarray]]]:
        """Yields (file_ids, batch) over the split once (a last partial
        batch dropped); process ``process_index`` of ``process_count`` takes
        every ``process_count``-th batch. One worker thread loads up to
        ``PREFETCH`` batches ahead of the one being used."""
        chunks = [chunk for chunk, _ in self.epoch_indices(
            batch_size, train=train, shuffle_seed=shuffle_seed,
            process_index=process_index, process_count=process_count)]
        if not chunks:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = [pool.submit(self._load_batch, c) for c in chunks[:PREFETCH]]
            next_submit = len(futures)
            for _ in range(len(chunks)):
                result = futures.pop(0).result()
                if next_submit < len(chunks):
                    futures.append(pool.submit(self._load_batch, chunks[next_submit]))
                    next_submit += 1
                yield result


def build_rgb_dataset(
    data_dir: str, label_file: str, cfg: PipelineConfig, mode: str = "train",
) -> LazyVideoBatcher:
    """RGB: per-video ``Sample#####_color.npy`` frames and class-id labels;
    CTC sees the padded length less the trim. The train split shuffles the
    sorted file NAMES, as the JAX package does (``datasets.py:296-326``)."""
    names = formats.list_video_files(data_dir)
    ids = [formats.video_file_id(n) for n in names]
    labels_map = formats.load_label_csv(label_file) if mode != "final" else {}
    N = len(ids)
    labels = np.zeros((N, cfg.max_label_len), np.int32)
    lab_len = np.zeros((N,), np.int32)
    in_len = np.full((N,), cfg.maxlen - cfg.ctc.trim_frames, np.int32)
    blank = cfg.nb_classes - 1
    for i, fid in enumerate(ids):
        seq = [] if mode == "final" else labels_map.get(fid, [])
        labels[i], lab_len[i] = prepare_labels(seq, cfg.max_label_len, blank,
                                               expand_words=False)
    if mode == "train":
        train_names, val_names = reference_split(names, cfg.val_split, cfg.batch_size,
                                                 seed=cfg.split_seed)
        train_ids = [formats.video_file_id(n) for n in train_names]
        val_ids = [formats.video_file_id(n) for n in val_names]
    else:
        train_ids, val_ids = [], ids
    return LazyVideoBatcher(data_dir, names, cfg, labels, lab_len, in_len, ids, train_ids,
                            val_ids)
