"""WAVs -> 39-d HTK MFCC -> per-file CSVs (``mgr_tpu/data/audio_pipeline.py``).

The WAV is read on the host; the featurizer (``ops/mfcc.py``) runs on the
``device`` given, and the ``audio_<id>.csv`` files the speech loaders read
(39 feature columns and ``file_number``, ``%.6f``) are written on the host.
"""

from __future__ import annotations

import dataclasses
import os
import re
import wave
from typing import List, Optional, Tuple

import numpy as np
import torch

from mgr_tpu_torch.ops.mfcc import MFCCConfig, mfcc_39

AUDIO_HEADER = ",".join(str(i) for i in range(39)) + ",file_number"


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM WAV of 1, 2 or 4 bytes a sample -> (f32 mono samples, sample
    rate); channels are averaged."""
    with wave.open(path, "rb") as w:
        rate, n = w.getframerate(), w.getnframes()
        width, channels = w.getsampwidth(), w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32)
    elif width == 1:
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def featurize_wav(path: str, cfg: Optional[MFCCConfig] = None, *,
                  device: torch.device | str = "cuda") -> np.ndarray:
    """One WAV -> (T, 39) MFCC and deltas, computed on ``device``; a config
    of another sample rate than the WAV's is rebuilt at the WAV's."""
    samples, rate = read_wav(path)
    cfg = cfg or MFCCConfig(sample_rate=rate)
    if cfg.sample_rate != rate:
        cfg = dataclasses.replace(cfg, sample_rate=rate)
    return mfcc_39(torch.from_numpy(samples).to(device), cfg).cpu().numpy()


def extract_directory(wav_dir: str, out_dir: str, *, file_pattern: str = r"Sample(\d+)",
                      cfg: Optional[MFCCConfig] = None,
                      device: torch.device | str = "cuda") -> List[int]:
    """Featurize every WAV of ``wav_dir`` whose name matches
    ``file_pattern`` into ``out_dir/audio_<id>.csv``, in sorted name order;
    returns the ids written."""
    os.makedirs(out_dir, exist_ok=True)
    ids: List[int] = []
    for name in sorted(os.listdir(wav_dir)):
        m = re.search(file_pattern, name)
        if not name.lower().endswith(".wav") or not m:
            continue
        fid = int(m.group(1))
        feats = featurize_wav(os.path.join(wav_dir, name), cfg, device=device)
        rows = np.concatenate([feats, np.full((feats.shape[0], 1), fid, np.float32)], axis=1)
        np.savetxt(os.path.join(out_dir, f"audio_{fid}.csv"), rows, delimiter=",",
                   header=AUDIO_HEADER, comments="", fmt="%.6f")
        ids.append(fid)
    return ids
