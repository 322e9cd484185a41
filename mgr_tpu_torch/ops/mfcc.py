"""HTK MFCC featurizer (``mgr_tpu/ops/mfcc.py``): 12 cepstra + C0 with a
25 ms Hamming window every 10 ms, in-frame pre-emphasis 0.97, 26 mel
channels and cepstral liftering 22, plus deltas and delta-deltas: 39
features a frame.

HTK's conventions, as the JAX package keeps them:
  * pre-emphasis inside each frame, after framing (sample 0 scaled by
    1 - k);
  * a symmetric Hamming window (``np.hamming``; ``torch.hamming_window``
    is periodic by default);
  * the filterbank sums the MAGNITUDE spectrum, with triangles linear in
    the mel domain, floored at 1.0 before the log;
  * c1..c12 then C0; deltas by the regression window with edge
    replication.

The functions run on the device of the signal they are given, in f32:
the FFT is ``torch.fft.rfft`` and the two products run with TF32 off.
The constants are host numpy, copied from the JAX package's module.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from mgr_tpu_torch.ops.precision import f32_matmul


@dataclass(frozen=True)
class MFCCConfig:
    sample_rate: int = 16000
    frame_ms: float = 25.0  # WINDOWSIZE 250000 (100 ns units)
    step_ms: float = 10.0  # TARGETRATE 100000
    preemphasis: float = 0.97  # PREEMCOEF
    num_filters: int = 26  # NUMCHANS
    num_ceps: int = 12  # NUMCEPS
    lifter: int = 22  # CEPLIFTER
    delta_window: int = 2  # HTK DELTAWINDOW default
    fft_size: int = 512

    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def frame_step(self) -> int:
        return int(round(self.sample_rate * self.step_ms / 1000.0))


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank(cfg: MFCCConfig) -> np.ndarray:
    """(fft_size//2 + 1, num_filters) triangles, linear in the mel domain
    between uniformly mel-spaced centres c * melmax / (P + 1)."""
    n_bins = cfg.fft_size // 2 + 1
    P = cfg.num_filters
    mhi = _hz_to_mel(cfg.sample_rate / 2.0)
    cf = np.arange(P + 2) * (mhi / (P + 1))
    bin_mels = _hz_to_mel(np.arange(n_bins) * cfg.sample_rate / cfg.fft_size)
    fb = np.zeros((n_bins, P), np.float32)
    for m in range(1, P + 1):
        lo, mid, hi = cf[m - 1], cf[m], cf[m + 1]
        up = (bin_mels - lo) / (mid - lo)
        down = (hi - bin_mels) / (hi - mid)
        fb[:, m - 1] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def _dct_matrix(num_filters: int, num_ceps: int) -> np.ndarray:
    """(num_filters, num_ceps + 1) DCT-II, column 0 for C0, sqrt(2/N)
    scaling."""
    i = np.arange(num_filters) + 0.5
    j = np.arange(num_ceps + 1)
    mat = np.cos(np.pi * np.outer(i, j) / num_filters)
    return (np.sqrt(2.0 / num_filters) * mat).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _lifter_weights(num_ceps: int, lifter: int) -> np.ndarray:
    j = np.arange(1, num_ceps + 1)
    return (1.0 + (lifter / 2.0) * np.sin(np.pi * j / lifter)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hamming(frame_len: int) -> np.ndarray:
    """The symmetric Hamming window of ``np.hamming``."""
    return np.hamming(frame_len).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def frame_signal(signal: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """(..., S) -> (..., T, frame_len) frames at the HTK step; indices past
    the end are clipped, so a signal shorter than a frame gives one."""
    flen, step = cfg.frame_len, cfg.frame_step
    S = signal.shape[-1]
    n_frames = max(1 + (S - flen) // step, 1)
    idx = (torch.arange(n_frames, device=signal.device)[:, None] * step
           + torch.arange(flen, device=signal.device)[None, :])
    return signal[..., idx.clamp(0, S - 1)]


def static_mfcc(signal: torch.Tensor, cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """(..., S) waveform -> (..., T, num_ceps + 1) [c1..c12, C0]."""
    frames = frame_signal(signal.float(), cfg)
    k = cfg.preemphasis
    pre = torch.cat([frames[..., :1] * (1.0 - k),
                     frames[..., 1:] - k * frames[..., :-1]], dim=-1)
    windowed = pre * _const(_hamming(cfg.frame_len), pre)
    spec = torch.fft.rfft(windowed, n=cfg.fft_size, dim=-1).abs()
    mel = f32_matmul(spec, _const(_mel_filterbank(cfg), spec)).clamp_min(1.0)
    ceps = f32_matmul(torch.log(mel), _const(_dct_matrix(cfg.num_filters, cfg.num_ceps), mel))
    cc = ceps[..., 1:] * _const(_lifter_weights(cfg.num_ceps, cfg.lifter), ceps)
    return torch.cat([cc, ceps[..., :1]], dim=-1)


def deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """HTK regression deltas over axis -2 with edge replication:
    d_t = sum_th th*(c_{t+th} - c_{t-th}) / (2 * sum th^2)."""
    T = feats.shape[-2]
    t = torch.arange(T, device=feats.device)
    denom = 2.0 * sum(th * th for th in range(1, window + 1))
    out = torch.zeros_like(feats)
    for th in range(1, window + 1):
        fwd = feats[..., (t + th).clamp(0, T - 1), :]
        bwd = feats[..., (t - th).clamp(0, T - 1), :]
        out = out + th * (fwd - bwd)
    return out / denom


def mfcc_39(signal: torch.Tensor, cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """(S,) waveform -> (T, 39): statics, deltas, delta-deltas."""
    static = static_mfcc(signal, cfg)
    d1 = deltas(static, cfg.delta_window)
    d2 = deltas(d1, cfg.delta_window)
    return torch.cat([static, d1, d2], dim=-1)


def batch_mfcc_39(signals: torch.Tensor, cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """(B, S) equal-length waveforms -> (B, T, 39)."""
    return mfcc_39(signals, cfg)
