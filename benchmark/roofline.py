"""The yardstick of the per-layer metrics: the card's peaks, the least time
of each kernel from the work it was given, and the model's FLOPs.

``bound``, ``lstm_bound`` and ``ctc_bound`` are a frozen copy of
``chip_smoke.py``'s, with one change: the CTC bound counts the lattice
states that the labels' lengths give (``ctc_visits``), in its bytes as in
its operations, where chip_smoke counts the alpha store at the padded
label width. Work is counted from the shapes and lengths of the work done,
whatever implements it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# the least time of a kernel is the larger of its bytes over the memory rate
# and its operations over the peak of their type.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12    # the recurrences multiply bf16 values (f32 sums)
F32_FLOPS = 67e12      # the CTC recursions: f32 outside the tensor cores
CTC_FWD_OPS = 13       # f32 ops per lattice state and step: max of 3 (2), 3 subtractions,
                       # 3 exp, 2 adds, log, add, + emission
CTC_BWD_OPS = 17       # the same beta recursion, + the occupancy (add, sub, exp) and its sum


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the peak rate of their type, whichever is larger."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / peak
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def lstm_bound(T, B, H, *, dirs, backward, store_c):
    """K1/K5a (forward: one (B,H)x(H,4H) product per step and direction)
    and K2/K5b (backward: two), bf16 operands."""
    products = 2 if backward else 1
    ops = dirs * T * products * 2 * B * H * 4 * H
    xp, stream, u = T * B * 4 * H * 2, T * B * H * 2, H * 4 * H * 2
    if backward:  # xp, U, hs, cs, dhs in; dz out
        nbytes = dirs * (xp + u + 3 * stream + xp)
    else:  # xp, U in; hs (and cs) out
        nbytes = dirs * (xp + u + (2 if store_c else 1) * stream)
    return bound(nbytes, ops, BF16_FLOPS)


def ctc_visits(in_len: Sequence[int], lab_len: Sequence[int]) -> float:
    """Lattice states the recursion visits: 2L+1 for each valid frame."""
    return float(sum(int(t) * (2 * int(n) + 1) for t, n in zip(in_len, lab_len)))


def ctc_bound(T, B, K, N, visits, *, backward, store=False):
    """K3 (loss only, or with ``store`` the alpha store too) / K4 over a
    (T, B, K) f32 log-prob tensor and (B, N) labels, from this run's
    lattice visits: the alphas that the recursion needs are one f32 a
    visited state (2L+1 a frame), whatever width a kernel pads them to."""
    lp_bytes, lens = T * B * K * 4, B * N * 4 + 2 * B * 4
    alpha_bytes = 4 * visits
    if backward:  # lp, both alpha stores, labels, lengths, two seeds in; d lp out
        nbytes = lp_bytes + alpha_bytes + lens + 2 * B * 4 + lp_bytes
        return bound(nbytes, CTC_BWD_OPS * visits, F32_FLOPS)
    # lp, labels, lengths in; the loss (and the alphas) out
    nbytes = lp_bytes + lens + B * 4 + (alpha_bytes if store else 0)
    return bound(nbytes, CTC_FWD_OPS * visits, F32_FLOPS)


def _conv_frames(cnn: Dict[str, Any]):
    """(flops of one frame's forward convs, flops of conv 0) of the CNN."""
    d, c_in, total, first = cnn["img_dim"], 1, 0.0, 0.0
    for i, (c_out, k, p) in enumerate(zip(cnn["channels"], cnn["kernel_sizes"],
                                          cnn["pool_sizes"])):
        o = d - k + 1
        f = 2.0 * o * o * c_out * c_in * k * k
        total += f
        first = f if i == 0 else first
        d, c_in = o // p, c_out
    return total, first, d * d * c_in


def model_flops(pipeline: Dict[str, Any], B: int, *, train: bool) -> float:
    """Matmul and convolution FLOPs of one forward (``train``: forward and
    backward) of a BLSTM-CTC pipeline over B sequences of ``maxlen``
    frames: each BiLSTM layer's two projections and two recurrences (one
    (B,H)x(H,4H) product a step), the head, and rgb's convolutions. The
    backward is twice the forward, less the input gradient no one needs
    (the first projection's, the first convolution's). Recompute (rgb's
    remat) is not counted; elementwise work and CTC are not counted."""
    T, enc = pipeline["maxlen"], pipeline["encoder"]
    H, C = enc["hidden"], pipeline["nb_classes"]
    frames = T * B
    total = first_input = 0.0
    F = pipeline["num_feats"]
    if pipeline.get("cnn"):
        conv, conv0, F = _conv_frames(pipeline["cnn"])
        total += frames * conv
        first_input = frames * conv0
    for i in range(enc["depth"]):
        proj = 2 * 2.0 * frames * F * 4 * H
        rec = 2 * 2.0 * frames * H * 4 * H
        total += proj + rec
        if i == 0 and not pipeline.get("cnn"):
            first_input = proj
        F = 2 * H
    total += 2.0 * frames * 2 * H * C
    if not train:
        return total
    return total + 2 * total - first_input
