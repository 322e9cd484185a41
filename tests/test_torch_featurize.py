"""The port's featurizers (``mgr_tpu_torch/ops/{mfcc,kinematics,image}.py``)
held against the JAX package's on the same seeded inputs, on the CPU.

Tolerances, each with its reason:
  * MFCC: rtol 1e-4 / atol 1e-3 against JAX (f32 FFTs and products in
    another order; the tolerance of ``tests/test_mfcc.py``'s golden
    vectors), and 5e-5 of the largest |value| against the independent f64
    oracle ``tests/htk_ref.py`` (as ``tests/test_mfcc.py`` holds JAX).
  * kinematics: the floored and truncated columns (stage-1 velocities, the
    rest position and the distances from it) exactly; the rest 1e-5
    absolute (atan2 in another library; the norms of integer tracks are
    correctly rounded on both sides).
  * ROI crops: 1e-3 on the 0-255 scale (f32 products of up to 640 terms
    in another order).
  * ``rgb_to_gray``: 1e-4 on the 0-255 scale.

Three traps each have a case that fails if the trap comes back: the
symmetric Hamming window (a periodic one moves the MFCCs by far more than
the tolerance), the median of an even count of rest frames (the lower
middle value moves the rest position), and the antialiased Keys weights of
a box that shrinks (unwidened weights alias).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_ref import htk_mfcc39
from mgr_tpu.ops import image as jimage
from mgr_tpu.ops import kinematics as jkin
from mgr_tpu.ops import mfcc as jmfcc
from mgr_tpu_torch.ops import image as timage
from mgr_tpu_torch.ops import kinematics as tkin
from mgr_tpu_torch.ops import mfcc as tmfcc

torch.set_num_threads(1)

JOINTS = ("lh", "rh", "le", "re", "hip", "shc")
EXACT_COLS = (4, 5)  # lh_dist_rp, rh_dist_rp: floored distances from a truncated median


def _signal(kind: str, seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    if kind == "noise":
        return (3000.0 * rng.standard_normal(n)).astype(np.float32)
    if kind == "tones":
        return ((0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t + 0.7)
                 + 0.05 * rng.standard_normal(n)) * 8000.0).astype(np.float32)
    f = 200.0 + 2800.0 * t / t[-1]  # chirp
    return (6000.0 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0)).astype(np.float32)


@pytest.mark.parametrize("kind,seconds", [("noise", 1.0), ("tones", 2.0), ("chirp", 1.5)])
def test_mfcc_39_matches_jax_and_the_htk_oracle(kind, seconds):
    sig = _signal(kind, seconds)
    got = tmfcc.mfcc_39(torch.from_numpy(sig)).numpy()
    want = np.asarray(jmfcc.mfcc_39(jnp.asarray(sig)))
    assert got.shape == want.shape == (1 + (len(sig) - 400) // 160, 39)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    oracle = htk_mfcc39(sig)
    scale = np.abs(oracle).max() + 1e-6
    np.testing.assert_allclose(got / scale, oracle / scale, atol=5e-5)


def test_mfcc_window_is_numpys_symmetric_hamming():
    """The window of ``np.hamming``, which PyTorch's default (periodic)
    window is not (with it, the parity cases above fail)."""
    win = tmfcc._hamming(400)
    np.testing.assert_array_equal(win, np.hamming(400).astype(np.float32))
    assert not np.allclose(win, torch.hamming_window(400).numpy(), atol=1e-3)


@pytest.mark.parametrize("samples", [100, 400, 401, 560])
def test_mfcc_short_signals_and_frame_edges(samples):
    """Shorter than a frame (one frame of clipped indices), exactly one
    frame, one sample over, and one step over."""
    sig = _signal("noise", 1.0, seed=samples)[:samples]
    got = tmfcc.mfcc_39(torch.from_numpy(sig)).numpy()
    want = np.asarray(jmfcc.mfcc_39(jnp.asarray(sig)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_batch_mfcc_and_deltas_match_jax():
    sigs = np.stack([_signal("tones", 0.5, seed=s) for s in range(3)])
    got = tmfcc.batch_mfcc_39(torch.from_numpy(sigs)).numpy()
    want = np.asarray(jmfcc.batch_mfcc_39(jnp.asarray(sigs)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    feats = np.random.default_rng(1).standard_normal((9, 13)).astype(np.float32)
    for window in (1, 2, 3):
        np.testing.assert_allclose(tmfcc.deltas(torch.from_numpy(feats), window).numpy(),
                                   np.asarray(jmfcc.deltas(jnp.asarray(feats), window)),
                                   atol=1e-6)


def test_mfcc_at_another_sample_rate_matches_jax():
    cfg_t = tmfcc.MFCCConfig(sample_rate=8000)
    cfg_j = jmfcc.MFCCConfig(sample_rate=8000)
    sig = _signal("noise", 1.0, seed=3)[:8000]
    np.testing.assert_allclose(tmfcc.mfcc_39(torch.from_numpy(sig), cfg_t).numpy(),
                               np.asarray(jmfcc.mfcc_39(jnp.asarray(sig), cfg_j)),
                               rtol=1e-4, atol=1e-3)


def _kinect_joints(seed: int, T: int) -> dict:
    """Integer Kinect tracks: a slow random walk per joint (so the hands
    rest on some frames), inside 640 x 480."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in JOINTS:
        start = rng.integers(100, 400, size=2)
        steps = rng.integers(-6, 7, size=(T, 2)) * (rng.random((T, 1)) < 0.5)
        out[name] = np.clip(start + np.cumsum(steps, axis=0), 0, 479).astype(np.float32)
    return out


def _both(fn_t, fn_j, joints):
    got = fn_t({k: torch.from_numpy(v) for k, v in joints.items()})
    want = fn_j({k: jnp.asarray(v) for k, v in joints.items()})
    return got, want


def _low_frames(joints) -> int:
    lh = np.asarray(jkin.hand_velocity_stage1(jnp.asarray(joints["lh"])))
    rh = np.asarray(jkin.hand_velocity_stage1(jnp.asarray(joints["rh"])))
    return int(((lh < lh.mean()) & (rh < rh.mean())).sum())


@pytest.mark.parametrize("seed,T", [(0, 40), (1, 57), (2, 120), (3, 9)])
def test_skeletal_features_match_jax(seed, T):
    joints = _kinect_joints(seed, T)
    got, want = _both(tkin.skeletal_features, jkin.skeletal_features, joints)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (T, 20)
    np.testing.assert_array_equal(got[:, EXACT_COLS], want[:, EXACT_COLS])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for fn in ("hand_velocity_stage1", "velocity"):
        for name in JOINTS:
            np.testing.assert_array_equal(getattr(tkin, fn)(torch.from_numpy(joints[name])),
                                          np.asarray(getattr(jkin, fn)(jnp.asarray(joints[name]))))


def test_rest_position_of_an_even_count_averages_the_middle_pair():
    """Four rest frames with x = 10, 20, 31, 40: the median is 25.5 ->
    truncated 25 (``torch.nanmedian`` would give 20)."""
    track = np.array([[10, 7], [500, 9], [20, 7], [31, 12], [600, 1], [40, 12]], np.float32)
    vel = np.array([0, 9, 0, 0, 9, 0], np.float32)
    got = tkin.rest_position({"lh": torch.from_numpy(track)}, torch.from_numpy(vel),
                             torch.from_numpy(vel))["lh"].numpy()
    want = np.asarray(jkin.rest_position({"lh": jnp.asarray(track)}, jnp.asarray(vel),
                                         jnp.asarray(vel))["lh"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [25.0, 9.0])


def test_rest_distance_with_an_even_count_of_rest_frames_matches_jax():
    """A whole video whose rest frames are an even count with a middle
    pair that differs by more than 1, through ``skeletal_features``: the
    two distance-from-rest columns exactly."""
    for seed in range(40):
        joints = _kinect_joints(100 + seed, 64)
        if _low_frames(joints) % 2:
            continue
        lhv = np.asarray(jkin.hand_velocity_stage1(jnp.asarray(joints["lh"])))
        rhv = np.asarray(jkin.hand_velocity_stage1(jnp.asarray(joints["rh"])))
        low = (lhv < lhv.mean()) & (rhv < rhv.mean())
        xs = np.sort(joints["lh"][low, 0])
        if xs[len(xs) // 2] - xs[len(xs) // 2 - 1] >= 2:
            break
    else:
        pytest.fail("no seed gives an even count of rest frames with a wide middle pair")
    got, want = _both(tkin.skeletal_features, jkin.skeletal_features, joints)
    np.testing.assert_array_equal(got.numpy()[:, EXACT_COLS], np.asarray(want)[:, EXACT_COLS])


def test_rest_position_with_no_rest_frame_is_nan_like_jax():
    track = np.tile(np.array([[5, 5]], np.float32), (6, 1))
    vel = np.zeros(6, np.float32)  # nothing below the mean
    got = tkin.rest_position({"lh": torch.from_numpy(track)}, torch.from_numpy(vel),
                             torch.from_numpy(vel))["lh"].numpy()
    want = np.asarray(jkin.rest_position({"lh": jnp.asarray(track)}, jnp.asarray(vel),
                                         jnp.asarray(vel))["lh"])
    assert np.isnan(got).all() and np.isnan(want).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_extra_features_match_jax(seed):
    joints = _kinect_joints(seed, 33)
    got, want = _both(tkin.extra_features, jkin.extra_features, joints)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_clip_kinect_range_matches_jax(dtype):
    xy = np.array([[639, 479], [640, 480], [700, 10], [5, 900], [0, 0]], dtype)
    got = tkin.clip_kinect_range(torch.from_numpy(xy)).numpy()
    want = np.asarray(jkin.clip_kinect_range(jnp.asarray(xy)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _frame(seed: int) -> np.ndarray:
    """A 480 x 640 frame with structure at every scale: smooth gradients
    plus uint8 noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    smooth = 100 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    return np.clip(smooth + rng.integers(-40, 41, size=(480, 640)), 0, 255).astype(np.float32)


BOXES = {
    "downscale (antialias)": (60.0, 420.0, 100.0, 460.0),  # 360 x 360 -> 60: kernel 6x wider
    "upscale (clipped corner)": (1.0, 40.0, 600.0, 639.0),  # 39 x 39 -> 60
    "fallback": timage.FALLBACK_BOX,
    "thin": (200.0, 200.5, 10.0, 630.0),  # height below 1 -> 1
}


@pytest.mark.parametrize("name", list(BOXES))
def test_crop_resize_frame_matches_jax(name):
    frame = _frame(len(name))
    box = np.asarray(BOXES[name], np.float32)
    got = timage.crop_resize_frame(torch.from_numpy(frame), torch.from_numpy(box)).numpy()
    want = np.asarray(jimage.crop_resize_frame(jnp.asarray(frame), jnp.asarray(box)))
    assert got.shape == want.shape == (60, 60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_downscale_weights_are_widened():
    """360 -> 60 samples: every output sample reads 24 input pixels (the
    4-pixel Keys support widened 6x), and its weights sum to 1."""
    w = timage.resample_weights(640, 60, torch.tensor([60.0 / 360.0]),
                                torch.tensor([-100.0 * 60.0 / 360.0]))[0]
    assert ((w != 0).sum(dim=0) == 24).all()
    np.testing.assert_allclose(w.sum(dim=0).numpy(), 1.0, atol=1e-6)


def test_extract_upper_body_video_matches_jax_with_gaps_in_valid():
    T = 7
    rng = np.random.default_rng(4)
    video = np.stack([_frame(10 + t) for t in range(T)]).astype(np.uint8)
    hip = np.stack([rng.integers(150, 500, size=T), rng.integers(250, 470, size=T)], 1)
    shc = np.stack([hip[:, 0], hip[:, 1] - rng.integers(100, 220, size=T)], 1)
    hip, shc = hip.astype(np.float32), shc.astype(np.float32)
    valid = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    got = timage.extract_upper_body_video(torch.from_numpy(video), torch.from_numpy(hip),
                                          torch.from_numpy(shc), 60,
                                          torch.from_numpy(valid)).numpy()
    want = np.asarray(jimage.extract_upper_body_video(
        jnp.asarray(video.astype(np.float32)), jnp.asarray(hip), jnp.asarray(shc), 60,
        jnp.asarray(valid)))
    assert got.shape == want.shape == (T, 60, 60, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_upper_body_box_matches_jax():
    hip = np.array([[300, 350], [630, 470], [0, 0], [10, 400]], np.float32)
    shc = np.array([[310, 100], [630, 20], [0, 0], [15, 300]], np.float32)
    got = timage.upper_body_box(torch.from_numpy(hip), torch.from_numpy(shc)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jimage.upper_body_box(jnp.asarray(hip), jnp.asarray(shc))))


def test_rgb_to_gray_matches_jax():
    frame = np.random.default_rng(2).integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    got = timage.rgb_to_gray(torch.from_numpy(frame)).numpy()
    want = np.asarray(jimage.rgb_to_gray(jnp.asarray(frame.astype(np.float32))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
