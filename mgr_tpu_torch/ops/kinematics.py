"""Skeletal kinematics (``mgr_tpu/ops/kinematics.py``): the reference's
three offline feature stages as one vectorised pass over (T, 2) joint
tracks, on the device of the tracks.

Conventions kept from the JAX package:
  * stage-3 velocities and accelerations zero the first 5 frames, the
    stage-1 hand velocity and rest distance the first 4; frame 0 is taken
    against a zero row (:func:`previous`);
  * the stage-1 columns floor and the rest position truncates, so these
    integer columns must come out exactly: a norm is the correctly rounded
    f32 square root of the summed squares (a sum exact in f32 for Kinect
    integers below 640), taken in f64 and rounded, because PyTorch's
    vectorised f32 ``sqrt`` on the CPU is within 0.5001 ulp, not 0.5;
  * the rest position is a median that averages the two middle values of
    an even count (``jnp.nanmedian``; ``torch.nanmedian`` returns the lower
    one), hence ``torch.nanquantile(..., 0.5)``.
"""

from __future__ import annotations

from typing import Dict

import torch

Joint = torch.Tensor  # (T, 2) x/y track


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(dim=-1).double()).float()


def _zero_first(x: torch.Tensor, n: int) -> torch.Tensor:
    t = torch.arange(x.shape[0], device=x.device)
    return torch.where(t < n, torch.zeros_like(x), x)


def previous(x: torch.Tensor) -> torch.Tensor:
    """Shift one frame forward; frame 0 becomes zeros."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def velocity(pos: Joint, zero_first: int = 5) -> torch.Tensor:
    """Inter-frame displacement against :func:`previous`, the first
    ``zero_first`` frames zeroed."""
    return _zero_first(_norm(pos - previous(pos)), zero_first)


def acceleration(vel: torch.Tensor, zero_first: int = 5) -> torch.Tensor:
    """Velocity delta, the first frames zeroed."""
    return _zero_first(vel - previous(vel), zero_first)


def distance(a: Joint, b: Joint) -> torch.Tensor:
    """Per-frame Euclidean distance between two joint tracks."""
    return _norm(a - b)


def angle(a: Joint, b: Joint) -> torch.Tensor:
    """arctan2(dy, dx) of (a - b)."""
    d = a - b
    return torch.atan2(d[..., 1], d[..., 0])


def hand_velocity_stage1(pos: Joint) -> torch.Tensor:
    """Stage-1 hand velocity: the floored inter-frame distance, the first
    4 frames zeroed."""
    return _zero_first(torch.floor(_norm(pos - previous(pos))), 4)


def rest_position(
    joints: Dict[str, Joint], lh_v: torch.Tensor, rh_v: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Median pose over the frames where both hand velocities are below
    their means, per joint: {joint: (2,) truncated medians} (NaN where no
    frame qualifies)."""
    low = (lh_v < lh_v.mean()) & (rh_v < rh_v.mean())
    out = {}
    for name, track in joints.items():
        masked = torch.where(low[:, None], track, torch.full_like(track, float("nan")))
        out[name] = torch.trunc(torch.nanquantile(masked, 0.5, dim=0))
    return out


def distance_from_rest(pos: Joint, rest: torch.Tensor) -> torch.Tensor:
    """Floored distance of a hand from its rest position, the first 4
    frames zeroed."""
    return _zero_first(torch.floor(_norm(pos - rest[None, :])), 4)


def skeletal_features(joints: Dict[str, Joint]) -> torch.Tensor:
    """(T, 20) features in the model's column order
    (``formats.SKELETAL_FEATURES``); ``joints`` needs lh, rh, le, re, hip
    and shc, each (T, 2)."""
    lh, rh, le, re = joints["lh"], joints["rh"], joints["le"], joints["re"]
    hip, shc = joints["hip"], joints["shc"]

    s1_lh_v, s1_rh_v = hand_velocity_stage1(lh), hand_velocity_stage1(rh)
    rp = rest_position({"lh": lh, "rh": rh}, s1_lh_v, s1_rh_v)
    cols = [
        velocity(lh), velocity(rh), velocity(le), velocity(re),
        distance_from_rest(lh, rp["lh"]), distance_from_rest(rh, rp["rh"]),
        distance(lh, hip), distance(rh, hip),
        distance(le, hip), distance(re, hip),
        distance(lh, shc), distance(rh, shc),
        distance(le, shc), distance(re, shc),
        angle(lh, hip), angle(rh, hip),
        angle(lh, shc), angle(rh, shc),
        angle(lh, le), angle(rh, re),
    ]
    return torch.stack(cols, dim=-1)


def extra_features(joints: Dict[str, Joint]) -> Dict[str, torch.Tensor]:
    """Stage-3 columns the model does not select: the inter-hand distance
    and the four accelerations."""
    lh, rh, le, re = joints["lh"], joints["rh"], joints["le"], joints["re"]
    out = {"hands_d": distance(lh, rh)}
    for name, track in (("lh", lh), ("rh", rh), ("le", le), ("re", re)):
        out[f"{name}_a"] = acceleration(velocity(track))
    return out


def clip_kinect_range(xy: torch.Tensor, width: int = 640, height: int = 480) -> torch.Tensor:
    """Out-of-range Kinect coordinates snap to the frame centre: x >= 640
    -> 320, y >= 480 -> 240."""
    x = torch.where(xy[..., 0] >= width, width // 2, xy[..., 0])
    y = torch.where(xy[..., 1] >= height, height // 2, xy[..., 1])
    return torch.stack([x, y], dim=-1)
