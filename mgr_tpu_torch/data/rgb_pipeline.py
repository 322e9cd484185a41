"""Videos -> (T, 60, 60, 1) upper-body crops (``mgr_tpu/data/rgb_pipeline.py``).

The video is decoded on the host: from pre-extracted gray frames in a
``.npy``, or from an ``.mp4`` when OpenCV is installed (it is not a
dependency). The frames go to the ``device`` as they are stored (uint8
frames stay uint8 on the way, a quarter of the f32 bytes), and the crop
and resample (``ops/image.py``) run there in f32. ``extract_directory``
writes ``Sample#####_color.npy`` as uint8 from the host copy, so values
the cubic filter puts outside [0, 255] convert as the JAX package's do.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
import torch

from mgr_tpu_torch.data.skeletal_pipeline import parse_kinect_csv
from mgr_tpu_torch.ops.image import extract_upper_body_video


def _load_video_frames(path: str) -> np.ndarray:
    """(T, H, W) gray frames from a ``.npy`` ((T, H, W) or (T, H, W, C),
    channel 0 kept) or an ``.mp4`` (OpenCV); uint8 and f32 frames are
    returned as stored, other dtypes as f32."""
    if path.endswith(".npy"):
        x = np.load(path)
        if x.ndim == 4:
            x = x[..., 0]
        return x if x.dtype in (np.uint8, np.float32) else x.astype(np.float32)
    try:
        import cv2  # noqa: PLC0415 — optional
    except ImportError as e:
        raise RuntimeError("mp4 decode needs OpenCV; pre-extract frames to .npy instead") from e
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while cap.isOpened():
            ret, img = cap.read()
            if not ret:
                break
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    finally:
        cap.release()
    return np.asarray(frames, np.uint8)


def _fit_track(track: np.ndarray, T: int) -> np.ndarray:
    """A (T', 2) track cut or edge-padded to T frames."""
    if track.shape[0] >= T:
        return track[:T]
    return np.concatenate([track, np.repeat(track[-1:], T - track.shape[0], axis=0)], axis=0)


def extract_video(video_path: str, hip: np.ndarray, shc: np.ndarray, out_dim: int = 60, *,
                  device: torch.device | str = "cuda") -> np.ndarray:
    """One video + (T', 2) hip and shoulder-centre tracks -> (T, D, D, 1)
    f32 crops, computed on ``device``. Frames where either track is (0, 0)
    use the fallback box."""
    frames = _load_video_frames(video_path)
    T = frames.shape[0]
    hip, shc = _fit_track(hip, T), _fit_track(shc, T)
    valid = (hip.sum(axis=1) > 0) & (shc.sum(axis=1) > 0)
    out = extract_upper_body_video(
        torch.from_numpy(frames).to(device), torch.from_numpy(hip).to(device),
        torch.from_numpy(shc).to(device), out_dim, torch.from_numpy(valid).to(device))
    return out.cpu().numpy()


def extract_directory(video_dir: str, skeletal_dir: str, out_dir: str, *, out_dim: int = 60,
                      file_pattern: str = r"Sample(\d+)",
                      device: torch.device | str = "cuda") -> List[int]:
    """ROI-extract every ``.mp4``/``.npy`` video of ``video_dir`` (sorted by
    name) whose id has a raw Kinect CSV in ``skeletal_dir`` (hip and
    shoulder centre) into ``out_dir/Sample#####_color.npy``; returns the
    ids written."""
    os.makedirs(out_dir, exist_ok=True)
    skel_by_id: Dict[int, str] = {}
    for name in os.listdir(skeletal_dir):
        m = re.search(file_pattern, name)
        if m and name.endswith(".csv"):
            skel_by_id[int(m.group(1))] = os.path.join(skeletal_dir, name)

    ids: List[int] = []
    for name in sorted(os.listdir(video_dir)):
        m = re.search(file_pattern, name)
        if not (name.endswith(".mp4") or name.endswith(".npy")) or not m:
            continue
        fid = int(m.group(1))
        if fid not in skel_by_id:
            print(f"skipping {name}: no skeletal CSV")
            continue
        joints = parse_kinect_csv(skel_by_id[fid])
        out = extract_video(os.path.join(video_dir, name), joints["hip"], joints["shc"],
                            out_dim, device=device)
        np.save(os.path.join(out_dir, f"Sample{fid:05d}_color.npy"), out.astype(np.uint8))
        ids.append(fid)
    return ids
