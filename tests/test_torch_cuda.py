"""The port's CUDA kernels on a CUDA device, against their plain versions.

Every test here needs a GPU: without one it skips (a CUDA kernel has no
interpret mode). The file imports no JAX and nothing of ``mgr_tpu``, so
on a GPU host it runs with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: K1 h and c streams 3e-2 absolute (bf16 streams, f32 sums in
another order); K3 loss 1e-4 relative to max(1, |loss|) (f32 logaddexp
chains) and its stored alphas 1e-4 relative to max(1, |alpha|); K2 dz
2e-2 relative to the largest |dz| (bf16 dz, recomputed z and f32 sums in
another order, carried over T steps) and dU 2e-2 relative Frobenius; K4
d log_probs 1e-4 absolute (f32 exp chains, probabilities in [-1, 1]);
whole-model logits on the card vs the CPU 3e-2 (bf16 model). K5a/K5b (the
single-direction entries of K1's and K2's sources) with K1's and K2's
tolerances against their plain versions, and bit-equal to the matching
direction of K1 and K2 (the same blocks run the same arithmetic). The
gloo exchange and a 2x2 mesh step with ranks sharing the card: the mesh
loss within 1e-3 relative and gradients within 5e-2 relative Frobenius of
the single-process step (bf16 model; other batch splits give other GEMM
shapes and sum orders). K6a/K6b (the batch-major entries of the same
sources) with K1's tolerance for h and c and K2's for dz (relative
Frobenius) and dU, bit-equal to K1/K2's directions (K5's for D=1) on the
same, time-flipped, projections; the batch-major layers on the card
against the CPU: outputs 3e-2, gradients 5e-2 relative Frobenius. The
input projection's bf16 backward: its f32 sums within 1e-5 of the largest
entry of the TF32-off f32 product of the same bf16 values (f32 sums in
another order), dx and dW those sums rounded once.

The tensor-core design of K1/K2 (split-K over 8 warps, fixed-order
reduction, per-direction split barrier) is held at its edges with the
same tolerances: the launch shape B=32, H=500 at short T; H=500 against
H=504 (h rows 8- and 16-byte aligned); B = 1, 16, 17, 64 and 256 (m16 and
32-row tile edges, one full launch); two launches bit-identical (the
reduction order depends only on H); and K1, K5a, K1 again on one stream
(each call's barrier counters are fresh). K2's dz there is held relative
to the largest |dz|, as in ``test_k2_matches_plain_version``. At H=512
(``MAX_H``, the rgb family's width) the same, at B = 1, 8, 32 and 256. The
rgb frontend in f32 on the card against the CPU: features 1e-5, conv
gradients 1e-4 relative Frobenius (f32 sums in another order; TF32 would
be ~1e-3 off). The featurizers on the card against the CPU, with the global
TF32 flag on during their products: MFCC rtol 1e-4 / atol 1e-3 (cuFFT
against the CPU's FFT), kinematics' floored and truncated columns exactly
and the rest 1e-5, ROI crops 1e-3 on the 0-255 scale. ``fit`` on the
corpus held on the card against ``fit`` on host batches: the same bits
and the same launches.

K1's two tilings (the same rule): K1's h and c at T=1900 and H=500 for B
= 32 to 256, at the late-fusion widths H=300 and 100 at B=64, and at H=512,
within TOL_K1 of the plain version and bit for bit the streams of the
one-group tiling run 32 rows at a time, of the other tiling forced over all
rows, and of K5a and K6a; every K1 launch of a train step and of a decode
call grouped at the benchmark cells' batches above 32 rows, none at 16 or 1.

K2's two tilings (``kernels/bilstm_tm.py::batch_groups``: one batch group
up to 32 rows, two from 33): K2 against its plain version on both sides of
the threshold and across launches (B = 65, 128, 129, 200 at H=500; B=128
at H=512 and H=100; B=520 at H=16, five launches of 128 rows); a grouped
launch's dz bit for bit the dz of the one-group tiling run on the same
rows in 32-row slices (a row's dz does not depend on the tiling); K5b and
K6b bit-equal to K2's direction at B=128; two launches at B=128
bit-identical; the grouped counter at B=128 and not at B=16 or 32; and a
train step of speech at B=128 (both K2 launches grouped) and of rgb at
B=16 (neither).

The kernels at the paths' full lengths (T=1900, CTC T'=1898) are cases of
the same tests, at the shapes the paths give them: K1 at B=128, H=500; K2
at B=1 to 256, H=500, in both tilings (the other one forced through
``batch_groups``), dz bit for bit the same; K1/K2 at the fusion layer's
H=100 and rgb's H=512; K3 loss only at B=128; K3's alphas and K4 at the
speech train batch and at the fusion and rgb presets' K and N, K4 within
1e-3 there (f32 exp chains over 1898 steps) and each valid frame's
gradient summing to -1 within 5e-2 (the f32 alphas reach -7e3, where one
ulp is 5e-4); K5 at B=32 and 128 and at the rows a 2x2 rank of each
family gives it, and K6 at B=32 and 128, dz in relative Frobenius norm.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.config import EncoderConfig, get_preset
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.kernels import ctc as k3
from mgr_tpu_torch.kernels import lstm_scan as k6
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.ops import ctc as tctc
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import step as step_lib
from mgr_tpu_torch.train.step import make_eval_step

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL_K1 = 3e-2
TOL_K3_REL = 1e-4
TOL_K2_REL = 2e-2
TOL_K4 = 1e-4
TOL_K4_LONG = 1e-3     # at T'=1898: f32 exp chains over 1898 steps
TOL_FRAME_SUM = 5e-2   # |sum_k d lp[t] + 1|: the f32 alphas reach -7e3 at t=1898, where
                       # one ulp is 5e-4, and y_pre = alpha - lp read back from them
                       # carries it into every step's weights (the JAX kernel's algorithm)
TOL_LOGITS = 3e-2


def _randn(gen, *shape):
    """Seeded standard normals (f32), drawn on the card: the full-length
    cases need up to 2.5e9 of them, minutes of a host draw."""
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("T,B,H", [
    (24, 3, 8), (40, 130, 300), (16, 1, 7), (12, 520, 16),
    (1900, 128, 500),  # the speech encoder's shape
])
def test_k1_matches_plain_version(cuda, T, B, H):
    """K1 (c stored) against its plain version; the launch without the c
    store (decode's) gives the same h bits, so two launches agree."""
    bf = torch.bfloat16
    xp = _randn(torch.Generator(cuda).manual_seed(H), 2, T, B, 4, H).to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(H), 4, H)["U"].to(cuda, bf)
    before = dispatch.launch_counts()["bilstm_tm_fwd"]
    got = k1.bilstm_tm(xp[0], xp[1], U, store_c=True)
    assert dispatch.launch_counts()["bilstm_tm_fwd"] == before + 1
    want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U, store_c=True)
    for g, w in zip(got, want):
        assert g.shape == (T, B, H)
        assert float((g - w).abs().max()) <= TOL_K1
    no_c = k1.bilstm_tm(xp[0], xp[1], U)
    assert all(torch.equal(a, b) for a, b in zip(no_c, got[:2]))


def test_k1_wide_launch_after_narrow_ones(cuda):
    """Shared memory grows with min(B, 128) and H: a launch that needs
    more than the ones before it, then again after a smaller one."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    for T, B, H in ((8, 128, 500), (8, 1, 16), (8, 128, 500)):
        xp = torch.randn((2, T, B, 4, H), generator=gen).to(cuda, bf)
        U = tlstm.init_bilstm_params(gen, 4, H)["U"].to(cuda, bf)
        got = k1.bilstm_tm(xp[0], xp[1], U)
        want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U)
        assert max(float((g - w).abs().max()) for g, w in zip(got, want)) <= TOL_K1


@pytest.mark.parametrize("B,T,K,N", [(4, 24, 6, 4), (7, 400, 44, 150),
                                     (128, 1898, 44, 150)])  # the speech shapes
def test_k3_matches_plain_version(cuda, B, T, K, N):
    rng = np.random.default_rng(N)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T, B, K)).astype(np.float32)), -1).to(cuda)
    lab_len = rng.integers(0, N + 1, size=B).astype(np.int32)
    labels = np.full((B, N), -1, np.int32)
    for b, n in enumerate(lab_len):
        labels[b, :n] = rng.integers(0, K - 1, size=n)
    labels[1, :] = (np.arange(N) // 2) % (K - 1)  # repeated labels
    lab_len[1] = N
    in_len = rng.integers(2 * N + 1, T + 1, size=B).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (labels, in_len, lab_len)]
    before = dispatch.launch_counts()["ctc_fwd"]
    got = k3.ctc_alpha_loss(lp, *args, K - 1)
    assert dispatch.launch_counts()["ctc_fwd"] == before + 1
    want = tctc.ctc_alpha_loss_plain(lp, *args, K - 1)
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(rel) <= TOL_K3_REL
    assert torch.equal(got, k3.ctc_alpha_loss(lp, *args, K - 1))  # two launches


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("bilstm_scan_tm_plain", "bilstm_scan_tm_bwd_plain"):
        monkeypatch.setattr(tlstm, name, refuse)
    for name in ("ctc_alpha_loss_plain", "ctc_alpha_bwd_plain"):
        monkeypatch.setattr(tctc, name, refuse)
    cfg = get_preset("speech").replace(maxlen=32, batch_size=2, max_label_len=4,
                                       encoder=EncoderConfig(hidden=16))
    model = build_model(cfg, device=cuda)
    rng = np.random.default_rng(0)
    batch = {
        "inputs": rng.standard_normal((2, 32, cfg.num_feats)).astype(np.float32),
        "labels": np.array([[1, 2, -1, -1], [3, 3, 3, -1]], np.int32),
        "input_length": np.array([30, 20], np.int32),
        "label_length": np.array([2, 3], np.int32),
    }
    assert np.isfinite(float(make_eval_step(model)(batch)))
    # The backward too: K2 and K4 under autograd.
    tb = {k: step_lib.to_device(batch[k], cuda) for k in step_lib.BATCH_KEYS}
    before = dispatch.launch_counts()
    loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), tb,
                                           prng.fold_name(prng.root_key(0), "dropout"))
    assert dispatch.launch_counts()["ctc_bwd"] == before["ctc_bwd"] + 1
    assert np.isfinite(float(loss)) and all(torch.isfinite(g).all() for g in grads.values())


def test_model_on_the_card_matches_the_cpu(cuda):
    cfg = get_preset("speech").replace(maxlen=48, encoder=EncoderConfig(hidden=32))
    cpu_model = build_model(cfg, seed=3, device="cpu")
    card_model = build_model(cfg, seed=3, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 48, cfg.num_feats)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_model(x)
        got = card_model(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= TOL_LOGITS


def _ctc_case(rng, B, T, K, N):
    lab_len = rng.integers(0, N + 1, size=B).astype(np.int32)
    labels = np.full((B, N), -1, np.int32)
    for b, n in enumerate(lab_len):
        labels[b, :n] = rng.integers(0, K - 1, size=n)
    labels[1, :] = (np.arange(N) // 2) % (K - 1)  # runs of repeated labels
    lab_len[1] = N
    lab_len[0] = 0
    in_len = rng.integers(2 * N + 1, T + 1, size=B).astype(np.int32)
    return labels, in_len, lab_len


@pytest.mark.parametrize("T,B,H", [
    (24, 3, 8), (40, 130, 300), (16, 1, 7), (12, 520, 16),
    (12, 65, 500), (12, 128, 500), (12, 129, 500), (12, 200, 500),  # two batch groups
    (12, 128, 512), (12, 128, 100),
])
def test_k2_matches_plain_version(cuda, T, B, H):
    gen = torch.Generator(cuda).manual_seed(H + 1)
    bf = torch.bfloat16
    xp = _randn(gen, 2, T, B, 4, H).to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(H), 4, H)["U"].to(cuda, bf)
    streams = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    dhs = _randn(gen, 2, T, B, H).to(bf)
    before = dispatch.launch_counts()["bilstm_tm_bwd"]
    grouped = dispatch.grouped_counts()["bilstm_tm_bwd"]
    got = k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    assert dispatch.launch_counts()["bilstm_tm_bwd"] == before + 1
    assert dispatch.grouped_counts()["bilstm_tm_bwd"] == grouped + (B >= k1.GROUPED_MIN_B)
    want = tlstm.bilstm_scan_tm_bwd_plain(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    for g, w in zip(got, want):
        assert g.shape == (T, B, 4, H) and g.dtype == bf
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= TOL_K2_REL * scale
    dU = tlstm.recurrent_weight_grad(streams[0], streams[1], *got)
    rel = float((dU - want[2]).norm() / want[2].norm())
    assert rel <= TOL_K2_REL


@pytest.mark.parametrize("T,B,H", [(12, 128, 500), (12, 200, 512)] + [
    (1900, B, 500) for B in (32, 64, 96, 128, 256)])  # the speech length, both sides of 33
def test_k2_groups_give_the_bits_of_one_group_slices(cuda, T, B, H, monkeypatch):
    """A row's dz does not depend on K2's tiling: the launch over all B
    rows (within the tolerances of K1 and K2, bit-identical when run
    again) gives, bit for bit, the dz of the one-group tiling run on the
    same rows 32 at a time, and of the other tiling forced over all of
    them."""
    (xp, U, dhs), streams, dz, (err_h, err_dz, err_dU) = _k1_k2_case(cuda, T, B, H, seed=B + H)
    assert err_h <= TOL_K1 and err_dz <= TOL_K2_REL and err_dU <= TOL_K2_REL, \
        (err_h, err_dz, err_dU)
    args = (xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    assert all(torch.equal(a, b) for a, b in zip(dz, k1.bilstm_tm_bwd(*args)))
    grouped = dispatch.grouped_counts()["bilstm_tm_bwd"]
    for b0 in range(0, B, 32):
        rows = slice(b0, min(B, b0 + 32))
        part = k1.bilstm_tm_bwd(xp[0][:, rows], xp[1][:, rows], U,
                                *(s[:, rows] for s in streams), dhs[0][:, rows], dhs[1][:, rows])
        for d in range(2):
            assert torch.equal(part[d], dz[d][:, rows]), (b0, d)
    assert dispatch.grouped_counts()["bilstm_tm_bwd"] == grouped  # the slices took one group
    other = 1 if B >= k1.GROUPED_MIN_B else 2
    monkeypatch.setattr(k1, "batch_groups", lambda *a, **k: other)
    assert all(torch.equal(a, b) for a, b in zip(dz, k1.bilstm_tm_bwd(*args)))


@pytest.mark.parametrize("T,B,H", [(1900, B, 500) for B in (32, 64, 96, 128, 256)] + [
    (1900, 64, 300), (1900, 64, 100),  # the late-fusion towers' and fusion layer's widths
    (12, 200, 512), (24, 100, 102)])   # two launches; h rows 4-byte aligned
def test_k1_groups_give_the_bits_of_one_group_slices(cuda, T, B, H, monkeypatch):
    """A row's h and c do not depend on K1's tiling: the launch over all B
    rows (within TOL_K1 of the plain version, bit-identical when run
    again) gives, bit for bit, the streams of the one-group tiling run on
    the same rows 32 at a time, and of the other tiling forced over all of
    them; so do K5a (each direction) and K6a over all rows. The grouped
    counter counts the launches that took two groups."""
    gen = torch.Generator(cuda).manual_seed(B + H + 1)
    bf = torch.bfloat16
    xp = 0.5 * _randn(gen, 2, T, B, 4, H)
    xp[:, :, :, 1, :] += 1.0
    xp = xp.to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(B + H), 4, H)["U"].to(cuda, bf)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    two = k1.batch_groups(B, H, sms) == 2
    assert two == (B >= k1.GROUPED_MIN_B)
    before = dispatch.launch_counts()["bilstm_tm_fwd"]
    grouped = dispatch.grouped_counts()["bilstm_tm_fwd"]
    streams = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    assert dispatch.launch_counts()["bilstm_tm_fwd"] == before + 1
    assert dispatch.grouped_counts()["bilstm_tm_fwd"] == grouped + two
    want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U, store_c=True)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(streams, want))
    assert err <= TOL_K1, err
    del want
    assert all(torch.equal(a, b) for a, b in
               zip(streams, k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)))
    grouped = dispatch.grouped_counts()["bilstm_tm_fwd"]
    for b0 in range(0, B, 32):
        rows = slice(b0, min(B, b0 + 32))
        part = k1.bilstm_tm_streams(xp[0][:, rows], xp[1][:, rows], U, store_c=True)
        for a, b in zip(part, streams):
            assert torch.equal(a, b[:, rows]), b0
    assert dispatch.grouped_counts()["bilstm_tm_fwd"] == grouped  # the slices took one group
    for d in range(2):  # K5a, one direction over all rows
        one = k1.lstm_tm_streams(xp[d], U[d], reverse=bool(d), store_c=True)
        assert torch.equal(one[0], streams[d]) and torch.equal(one[1], streams[2 + d]), d
    bm = torch.stack([xp[0], xp[1].flip(0)]).transpose(1, 2).contiguous()  # K6a's layout
    hs, cs = k6.lstm_scan_streams(bm, U, store_c=True)
    del bm
    for d in range(2):
        h, c = (x[d].transpose(0, 1) for x in (hs, cs))
        if d == 1:
            h, c = h.flip(0), c.flip(0)
        assert torch.equal(h, streams[d]) and torch.equal(c, streams[2 + d]), d
    other = 1 if two else 2
    monkeypatch.setattr(k1, "batch_groups", lambda *a, **k: other)
    grouped = dispatch.grouped_counts()["bilstm_tm_fwd"]
    assert all(torch.equal(a, b) for a, b in
               zip(streams, k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)))
    assert dispatch.grouped_counts()["bilstm_tm_fwd"] == grouped + (other == 2)


@pytest.mark.parametrize("B", [16, 32, 128])
def test_k2_grouped_counter(cuda, B):
    """K2, K5b and K6b count a grouped launch from 33 rows on, and none
    at B=16 or B=32, where the one-group tiling keeps the per-step floor."""
    T, H = 8, 500
    rng = np.random.default_rng(B)
    bf = torch.bfloat16
    xp = torch.from_numpy(0.5 * rng.standard_normal((2, T, B, 4, H)).astype(np.float32)).to(
        cuda, bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(B), 4, H)["U"].to(cuda, bf)
    dhs = torch.from_numpy(0.1 * rng.standard_normal((2, T, B, H)).astype(np.float32)).to(
        cuda, bf)
    streams = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    dispatch.reset_launch_counts()
    k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    k1.lstm_tm_bwd(xp[0], U[0], streams[0], streams[2], dhs[0], reverse=False)
    bm = xp[:1].transpose(1, 2).contiguous()
    hs, cs = k6.lstm_scan_streams(bm, U[:1], store_c=True)
    k6.lstm_scan_bwd(bm, U[:1], hs, cs, dhs[:1].transpose(1, 2).contiguous())
    one = int(B > 32)
    assert dispatch.grouped_counts() == {"bilstm_tm_fwd": 0, "lstm_tm_fwd": 0,
                                         "lstm_scan_fwd": one,  # K6a's streams, after the reset
                                         "bilstm_tm_bwd": one, "lstm_tm_bwd": one,
                                         "lstm_scan_bwd": one}
    counts = dispatch.launch_counts()
    assert counts["bilstm_tm_bwd"] == counts["lstm_tm_bwd"] == counts["lstm_scan_bwd"] == 1


@pytest.mark.parametrize("B,T,K,N,tol_k4", [
    (4, 24, 6, 4, TOL_K4), (7, 400, 44, 150, TOL_K4),
    # T'=1898: the speech train batch, the fusion presets' K and N, rgb's
    (32, 1898, 44, 150, TOL_K4_LONG), (32, 1898, 22, 35, TOL_K4_LONG),
    (8, 1898, 22, 28, TOL_K4_LONG),
])
def test_k3_alphas_and_k4_match_plain_versions(cuda, B, T, K, N, tol_k4):
    """K3's loss and stored alphas, and K4 on the plain version's alphas,
    against their plain versions: K4 on a seed independent of the alphas
    (g_emit uniform in [0, 1)) and as the loss seeds it, zero past each
    length, and with the loss's seeds each valid frame's gradient summing
    to -1 (the occupancies of a frame sum to 1); two launches of K3, and
    of K4 on K3's own alphas, bit-identical."""
    rng = np.random.default_rng(N + 1)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T, B, K)).astype(np.float32)), -1).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in _ctc_case(rng, B, T, K, N)]
    got = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    want = tctc.ctc_alpha_loss_plain(lp, *args, K - 1, store_alphas=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_K3_REL
    again = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rows, L = torch.arange(B, device=cuda), args[2].long()
    g_phi = -torch.exp(want[1][-1][rows, L] + want[0])
    loss_seeds = torch.where(
        L > 0, -torch.exp(want[2][-1][rows, (L - 1).clamp_min(0)] + want[0]), 0.0)
    past = torch.arange(T, device=cuda)[:, None] >= args[1][None, :]  # t >= len
    for g_emit in (torch.rand(B, device=cuda), loss_seeds):
        before = dispatch.launch_counts()["ctc_bwd"]
        d_got = k3.ctc_alpha_bwd(lp, *args, K - 1, want[1], want[2], g_phi, g_emit)
        assert dispatch.launch_counts()["ctc_bwd"] == before + 1
        d_want = tctc.ctc_alpha_bwd_plain(lp, *args, K - 1, want[1], want[2], g_phi, g_emit)
        assert torch.isfinite(d_got).all()
        assert float((d_got - d_want).abs().max()) <= tol_k4
        assert bool((d_got[past] == 0).all())
    # d_got is the loss seeds' gradient, the last of the loop.
    assert float((d_got.sum(-1)[~past] + 1.0).abs().max()) <= TOL_FRAME_SUM
    own = (lp, *args, K - 1, got[1], got[2], g_phi, loss_seeds)
    assert torch.equal(k3.ctc_alpha_bwd(*own), k3.ctc_alpha_bwd(*own))


def _ctc_edge(rng, T, B, K, N, in_len, lab_len):
    """Seeded log-probs and labels with runs of repeated labels; row 0 has
    a label >= K where N > 1 (it scores 0 and gets no gradient)."""
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T, B, K)).astype(np.float32)), -1)
    labels = np.full((B, N), -1, np.int32)
    for b, n in enumerate(lab_len):
        seq = rng.integers(0, K - 1, size=n)
        seq[1::3] = seq[0::3][: len(seq[1::3])]  # runs of two
        labels[b, :n] = seq
    if N > 1 and lab_len[0] > 1:
        labels[0, 1] = K + 3
    return lp, [torch.from_numpy(np.asarray(a, np.int32)) for a in (labels, in_len, lab_len)]


# The design's edges: N = 1023 (the largest block, K4's chunk at its floor
# of 2 frames) and N = 0; T below a chunk and T not a multiple of it; K =
# 300 wider than a block of 32; input lengths 0, 1 and T; runs of repeated
# labels and a label >= K. (T, K, N, input lengths, label lengths.)
CTC_EDGES = {
    "N=1023": (1400, 44, 1023, [1400, 1300], [1023, 600]),
    "N=0": (20, 6, 0, [20, 7, 1, 0], [0, 0, 0, 0]),
    "T below a chunk": (5, 6, 2, [5, 3, 1, 0], [2, 1, 1, 0]),
    "T not a multiple of a chunk": (37, 44, 8, [37, 17, 1, 0], [8, 5, 1, 2]),
    "K=300, N=4": (40, 300, 4, [40, 1, 0, 23], [4, 1, 0, 4]),
    "repeats, label >= K": (50, 10, 6, [50, 33, 1, 50], [6, 6, 1, 3]),
}


@pytest.mark.parametrize("case", sorted(CTC_EDGES))
def test_k3_k4_design_edges(cuda, case):
    """K3 (loss and stored alphas) and K4 against their plain versions, K4
    on the plain version's alphas; zero past each length."""
    T, K, N, in_len, lab_len = CTC_EDGES[case]
    B = len(in_len)
    lp, args = _ctc_edge(np.random.default_rng(T + K + N), T, B, K, N, in_len, lab_len)
    lp, args = lp.to(cuda), [a.to(cuda) for a in args]
    shape = k3.launch_shape(k3.BWD_NAME, N, K)
    if case == "N=1023":
        assert shape["threads"] == 1024 and shape["chunk_frames"] == 2
    if case == "K=300, N=4":
        assert shape["threads"] == 32
    loss = k3.ctc_alpha_loss(lp, *args, K - 1)
    got = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    want = tctc.ctc_alpha_loss_plain(lp, *args, K - 1, store_alphas=True)
    assert torch.equal(loss, got[0])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rel = (g - w).abs() / w.abs().clamp_min(1.0)
        assert rel.numel() == 0 or float(rel.max()) <= TOL_K3_REL
    rows, L = torch.arange(B, device=cuda), args[2].long()
    g_phi = -torch.exp(want[1][-1][rows, L] + want[0])
    g_emit = torch.zeros_like(g_phi)
    if N:
        g_emit = torch.where(L > 0, -torch.exp(
            want[2][-1][rows, (L - 1).clamp_min(0)] + want[0]), 0.0)
    d_got = k3.ctc_alpha_bwd(lp, *args, K - 1, want[1], want[2], g_phi, g_emit)
    d_want = tctc.ctc_alpha_bwd_plain(lp, *args, K - 1, want[1], want[2], g_phi, g_emit)
    assert torch.isfinite(d_got).all()
    assert float((d_got - d_want).abs().max()) <= TOL_K4
    past = torch.arange(T, device=cuda)[:, None] >= args[1][None, :]
    assert bool((d_got[past] == 0).all())


def test_k3_k4_two_launches_are_bit_identical(cuda):
    """No atomics, fixed summation orders: repeated labels (which several
    columns scatter onto one class) give the same bits launch after launch."""
    T, K, N = 400, 44, 150
    lp, args = _ctc_edge(np.random.default_rng(3), T, 7, K, N,
                         [400, 390, 350, 1, 0, 400, 320], [150, 150, 120, 1, 0, 90, 40])
    lp, args = lp.to(cuda), [a.to(cuda) for a in args]
    first = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    again = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    loss, a_phi, a_emit = first
    g = -torch.ones_like(loss)
    d_first = k3.ctc_alpha_bwd(lp, *args, K - 1, a_phi, a_emit, g, g)
    d_again = k3.ctc_alpha_bwd(lp, *args, K - 1, a_phi, a_emit, g, g)
    assert torch.equal(d_first, d_again)


def test_train_autograd_functions_on_the_card(cuda):
    """The layer and the loss differentiate through K2 and K4 on the card
    and agree with the same step through the plain versions on the CPU."""
    cfg = get_preset("speech").replace(maxlen=32, batch_size=3, max_label_len=4,
                                       encoder=EncoderConfig(hidden=16))
    rng = np.random.default_rng(2)
    batch = {
        "inputs": rng.standard_normal((3, 32, cfg.num_feats)).astype(np.float32),
        "labels": np.array([[1, 2, -1, -1], [3, 3, 3, -1], [-1, -1, -1, -1]], np.int32),
        "input_length": np.array([30, 20, 25], np.int32),
        "label_length": np.array([2, 3, 0], np.int32),
    }
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(cfg, seed=1, device=dev)
        logits = model.apply_tm(torch.from_numpy(batch["inputs"]).to(dev))
        loss = tctc.ctc_loss_from_logits(
            logits, *(torch.from_numpy(batch[k]).to(dev) for k in
                      ("labels", "input_length", "label_length")),
            trim_frames=2, time_major=True).mean()
        before = dispatch.launch_counts()
        loss.backward()
        after = dispatch.launch_counts()
        if dev.type == "cuda":
            assert after["bilstm_tm_bwd"] == before["bilstm_tm_bwd"] + 2
            assert after["ctc_bwd"] == before["ctc_bwd"] + 1
        grads[dev.type] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for k, want in grads["cpu"].items():
        rel = float((grads["cuda"][k] - want).norm() / want.norm().clamp_min(1e-12))
        assert rel <= 5e-2, (k, rel)


F32_GEMMS = ("sgemm", "gemm_f32f32")  # cuBLAS's f32 GEMMs outside the tensor cores


def _card_kernels(fn, tmp_path):
    """The names of the kernels the card ran in ``fn()``, read from the
    chrome trace of a ``torch.profiler`` session around it, and what
    ``fn`` returned. A session whose trace holds no kernel at all is run
    again, twice at most: CUPTI has been seen to deliver no device event
    for a short session."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        path = tmp_path / f"trace_{attempt}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        names = {e["name"] for e in events if e.get("cat") == "kernel"}
        if names:
            break
    return names, out


def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor, slack: float) -> bool:
    """Each entry of ``got`` (bf16 values) within one bf16 ulp of ``want``
    (f32) rounded to bf16, beyond ``slack``: the bound on the f32 sums'
    difference, which is relative to the largest entry and so exceeds an
    ulp of the smallest ones."""
    r = want.cpu().to(torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return bool(((got.cpu().float() - r).abs() <= ulp + slack).all())


@pytest.mark.parametrize("dtype,per_gate", [(torch.bfloat16, False), (torch.bfloat16, True),
                                            (torch.float32, False)],
                         ids=["bf16", "bf16-per-gate", "f32"])
def test_projection_backward_on_the_card(cuda, dtype, per_gate, tmp_path):
    """``input_projection``'s backward at T=64, B=32, F=1000, H=500 on
    dropout-scaled operands. In bf16 it multiplies the bf16 operands on
    tensor cores with f32 sums (no f32 GEMM kernel runs): its f32 sums
    within 1e-5 of the largest entry of the f32, TF32-off product of the
    same values, dx and dW those sums rounded once, so within one bf16 ulp
    of that product rounded (beyond the sums' 1e-5), db within 1e-5; with
    per-gate masks within 1e-2 of the same step on the CPU. In f32 it keeps
    the f32 product."""
    T, B, F, H = 64, 32, 1000, 500
    rng = np.random.default_rng(20)

    def on(a, dt=torch.float32, dev=cuda):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    keep = rng.random((4, B, F) if per_gate else (B, F)) < 0.6
    host = [rng.standard_normal((T, B, F)), rng.uniform(-0.05, 0.05, (F, 4, H)),
            rng.standard_normal((4, H)), rng.standard_normal((T, B, 4, H)), keep / 0.6]

    def run(dev):
        x, W, b, g, scale = (on(a, dt, dev) for a, dt in
                             zip(host, (dtype, torch.float32, torch.float32, dtype, dtype)))
        xs = (x if per_gate else x * scale).requires_grad_()
        W.requires_grad_()
        b.requires_grad_()
        out = tlstm.input_projection(xs, W, b, dtype, gate_scale=scale if per_gate else None)
        return (xs, W, b, g), out

    def backward():
        (xs, W, b, g), out = run(cuda)
        out.backward(g)
        return xs, W, b, g

    kernels, (xs, W, b, g) = _card_kernels(backward, tmp_path)
    gemms = sorted(n for n in kernels if "gemm" in n or "nvjet" in n)
    assert gemms, kernels
    f32_gemms = [n for n in gemms if any(k in n for k in F32_GEMMS)]
    assert bool(f32_gemms) == (dtype == torch.float32), gemms

    if per_gate:
        (xc, Wc, bc, gc), outc = run(torch.device("cpu"))
        outc.backward(gc)
        for got, want in ((xs.grad, xc.grad), (W.grad, Wc.grad), (b.grad, bc.grad)):
            err = float((got.cpu().float() - want.float()).abs().max())
            assert err <= 1e-2 * float(want.float().abs().max()), err
        return
    g2 = g.float().reshape(-1, 4 * H)
    x2, w2 = xs.detach().float().reshape(-1, F), W.detach().to(dtype).float().reshape(F, 4 * H)
    want = {"dx": g2 @ w2.t(), "dW": x2.t() @ g2, "db": g2.sum(0)}  # TF32 off (fixture)

    def slack(ref):
        return 1e-5 * float(ref.abs().max())

    def close(got, ref):
        return float((got.float() - ref).abs().max()) <= slack(ref)

    got = {"dx": xs.grad.reshape(-1, F), "dW": W.grad.reshape(F, 4 * H),
           "db": b.grad.reshape(4 * H)}
    assert got["db"].dtype == torch.float32 and close(got["db"], want["db"])
    if dtype == torch.float32:
        assert close(got["dx"], want["dx"]) and close(got["dW"], want["dW"])
        return
    gb, wb, xb = g.reshape(-1, 4 * H), w2.to(dtype), x2.to(dtype)
    sums = {"dx": tlstm._mm_f32(gb, wb.t()), "dW": tlstm._mm_f32(xb.t(), gb)}  # the backward's
    assert xs.grad.dtype == dtype
    for k in ("dx", "dW"):
        assert close(sums[k], want[k]), k
        assert torch.equal(got[k].float(), sums[k].to(dtype).float()), k
        assert _within_one_bf16_ulp(got[k], want[k], slack(want[k])), k


@pytest.mark.parametrize("T,B,H,dz_fro", [
    (24, 3, 8, False), (40, 130, 300, False), (16, 1, 7, False), (12, 300, 16, False),
    (12, 128, 500, False),
    # The speech length: B=32 (a 1x2 mesh rank) and 128; the edge shapes at
    # T=64; the rows a 2x2 rank of each family gives K5 (rgb's H=512, the
    # fusion layer's 100, the speech encoder's 500, the skeletal one's 300).
    (1900, 32, 500, True), (1900, 128, 500, True),
    (64, 1, 500, True), (64, 300, 64, True), (64, 3, 7, True),
    (1900, 4, 512, True), (1900, 16, 100, True), (1900, 16, 500, True), (1900, 16, 300, True),
])
@pytest.mark.parametrize("reverse", [False, True])
def test_k5_matches_plain_version_and_k1_k2(cuda, T, B, H, dz_fro, reverse):
    """K5a/K5b against their plain versions and bit-equal to K1/K2's
    direction. ``dz_fro`` holds dz in relative Frobenius norm, not
    relative to its largest entry: a recomputed z within an ulp of +-2.5
    gets the hard sigmoid's slope 0.2 on one side and 0 on the other,
    which moves that one dz entry by its own size; bit-equality with K2 is
    the strict check."""
    gen = torch.Generator(cuda).manual_seed(H + 2)
    bf = torch.bfloat16
    xp = _randn(gen, 2, T, B, 4, H).to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(H), 4, H)["U"].to(cuda, bf)
    d = int(reverse)
    before = dispatch.launch_counts()
    hs, cs = k1.lstm_tm_streams(xp[d], U[d], reverse=reverse, store_c=True)
    assert dispatch.launch_counts()["lstm_tm_fwd"] == before["lstm_tm_fwd"] + 1
    want = tlstm.lstm_scan_tm_plain(xp[d], U[d], reverse=reverse, store_c=True)
    for g, w in zip((hs, cs), want):
        assert g.shape == (T, B, H) and g.dtype == bf
        assert float((g.float() - w).abs().max()) <= TOL_K1
    two = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    assert torch.equal(hs, two[d]) and torch.equal(cs, two[2 + d])

    dhs = _randn(gen, 2, T, B, H).to(bf)
    dz = k1.lstm_tm_bwd(xp[d], U[d], hs, cs, dhs[d], reverse=reverse)
    assert dispatch.launch_counts()["lstm_tm_bwd"] == before["lstm_tm_bwd"] + 1
    assert dispatch.launch_counts()["bilstm_tm_bwd"] == before["bilstm_tm_bwd"]
    dz_w, dU_w = tlstm.lstm_scan_tm_bwd_plain(xp[d], U[d], hs, cs, dhs[d], reverse=reverse)
    assert dz.shape == (T, B, 4, H) and dz.dtype == bf
    ddz = dz.float() - dz_w.float()
    if dz_fro:
        assert float(ddz.norm() / dz_w.float().norm()) <= TOL_K2_REL
    else:
        assert float(ddz.abs().max()) <= TOL_K2_REL * float(dz_w.float().abs().max())
    dU = tlstm.lstm_weight_grad(hs, dz, reverse=reverse)
    assert float((dU - dU_w).norm() / dU_w.norm()) <= TOL_K2_REL
    dz_two = k1.bilstm_tm_bwd(xp[0], xp[1], U, *two, dhs[0], dhs[1])
    assert torch.equal(dz, dz_two[d])


def test_k5_autograd_function_on_the_card(cuda):
    """LSTMTm on the card against the same Function on the CPU (plain
    versions): h, dxp and dU."""
    rng = np.random.default_rng(9)
    xp = rng.standard_normal((20, 3, 4, 16)).astype(np.float32)
    U = 0.3 * rng.standard_normal((16, 4, 16)).astype(np.float32)
    g = rng.standard_normal((20, 3, 16)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(xp).to(dev, torch.bfloat16).requires_grad_()
        u = torch.from_numpy(U).to(dev).requires_grad_()
        h = k1.LSTMTm.apply(x, u, True)
        (h * torch.from_numpy(g).to(dev)).sum().backward()
        out[dev.type] = [t.detach().float().cpu() for t in (h, x.grad, u.grad)]
    for a, b, tol in zip(out["cuda"], out["cpu"], (TOL_K1, 5e-2, 5e-2)):
        assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def _gloo_card_rank(rank, world, dtype):
    """The direction exchange over gloo with both ranks on the one card."""
    import torch.distributed as dist

    from mgr_tpu_torch.parallel import collectives

    dev = torch.device("cuda", 0)
    h = torch.full((3, 2, 4), float(rank + 1), dtype=dtype, device=dev).requires_grad_()
    both = collectives.gather_directions(h, dist.group.WORLD, rank)
    both.float().sum().backward()
    return both.detach().float().cpu().numpy(), h.grad.float().cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gloo_exchange_of_card_tensors(cuda, dtype):
    out = run_ranks(_gloo_card_rank, 2, (dtype,), timeout_s=300)
    for r, (both, dh) in enumerate(out):
        assert (both[0] == 1).all() and (both[1] == 2).all()
        assert (dh == 2).all()  # one from each rank's loss


def _mesh_card_rank(rank, world, shape):
    from mgr_tpu_torch.core.config import MeshConfig
    from mgr_tpu_torch.parallel.mesh import make_mesh

    cfg = _small_speech()
    mesh = make_mesh(MeshConfig(*shape), device="cuda:0")
    model = build_model(cfg, seed=4, device=mesh.device)
    dispatch.reset_launch_counts()
    loss, grads = step_lib.mesh_loss_and_grads(
        model, mesh, dict(model.named_parameters()), _small_batch(cfg), None)
    return (float(loss), {k: g.cpu() for k, g in grads.items()},
            dispatch.launch_counts())


def _small_speech():
    enc = EncoderConfig(hidden=16, input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0)
    return get_preset("speech").replace(maxlen=32, batch_size=4, max_label_len=4, encoder=enc)


def _small_batch(cfg):
    rng = np.random.default_rng(6)
    return {
        "inputs": rng.standard_normal((4, 32, cfg.num_feats)).astype(np.float32),
        "labels": np.array([[1, 2, -1, -1], [3, 3, 3, -1], [-1, -1, -1, -1], [5, 4, -1, -1]],
                           np.int32),
        "input_length": np.array([30, 20, 25, 30], np.int32),
        "label_length": np.array([2, 3, 0, 2], np.int32),
    }


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_mesh_step_with_ranks_sharing_the_card(cuda, shape):
    cfg = _small_speech()
    model = build_model(cfg, seed=4, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _small_batch(cfg).items()}
    loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), batch, None)
    out = run_ranks(_mesh_card_rank, shape[0] * shape[1], (shape,), timeout_s=300)
    for m_loss, m_grads, counts in out:
        assert abs(m_loss - float(loss)) <= 1e-3 * abs(float(loss))
        for k, g in grads.items():
            rel = float((m_grads[k] - g.cpu()).norm() / g.norm().clamp_min(1e-12))
            assert rel <= 5e-2, (k, rel)
        one = shape[1] == 2
        assert (counts["lstm_tm_fwd"] > 0) == one and (counts["lstm_tm_bwd"] > 0) == one
        assert (counts["bilstm_tm_fwd"] > 0) != one and (counts["bilstm_tm_bwd"] > 0) != one


@pytest.mark.parametrize("T,B,H", [(24, 3, 8), (40, 130, 300), (16, 1, 7), (12, 300, 16),
                                   (12, 128, 500),
                                   (1900, 32, 500), (1900, 128, 500),  # the speech length
                                   (64, 1, 500), (64, 300, 64), (64, 3, 7), (64, 300, 7)])
@pytest.mark.parametrize("D", [1, 2])
def test_k6_matches_plain_version_and_k1_k2(cuda, T, B, H, D):
    gen = torch.Generator(cuda).manual_seed(H + 3)
    bf = torch.bfloat16
    xp = _randn(gen, D, B, T, 4, H).to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(H), 4, H)["U"][:D].to(cuda, bf)
    dhs = _randn(gen, D, B, T, H).to(bf)
    before = dispatch.launch_counts()
    hs, cs = k6.lstm_scan_streams(xp, U, store_c=True)
    assert dispatch.launch_counts()["lstm_scan_fwd"] == before["lstm_scan_fwd"] + 1
    want = tlstm.recurrent_scan_plain(xp, U, store_c=True)
    for g, w in zip((hs, cs), want):
        assert g.shape == (D, B, T, H) and g.dtype == bf
        assert float((g.float() - w).abs().max()) <= TOL_K1
    dz = k6.lstm_scan_bwd(xp, U, hs, cs, dhs)
    assert dispatch.launch_counts()["lstm_scan_bwd"] == before["lstm_scan_bwd"] + 1
    dz_w = tlstm.recurrent_scan_bwd_plain(xp, U, hs, cs, dhs)
    assert dz.shape == (D, B, T, 4, H) and dz.dtype == bf
    assert float((dz.float() - dz_w.float()).norm() / dz_w.float().norm()) <= TOL_K2_REL
    dU, dU_w = tlstm.scan_weight_grad(hs, dz), tlstm.scan_weight_grad(hs, dz_w)
    assert float((dU - dU_w).norm() / dU_w.norm()) <= TOL_K2_REL

    # The same blocks as K1/K2 (K5a/K5b for one direction): direction 1 of
    # K6 on its flipped projection is K1's reverse scan on the original.
    def tm(a, d):
        a = a[d].transpose(0, 1)
        return a.flip(0) if d == 1 else a

    if D == 1:
        one = k1.lstm_tm_streams(tm(xp, 0), U[0], reverse=False, store_c=True)
        dz_one = k1.lstm_tm_bwd(tm(xp, 0), U[0], *one, tm(dhs, 0), reverse=False)
        assert torch.equal(tm(hs, 0), one[0]) and torch.equal(tm(cs, 0), one[1])
        assert torch.equal(tm(dz, 0), dz_one)
    else:
        two = k1.bilstm_tm_streams(tm(xp, 0), tm(xp, 1), U, store_c=True)
        dz_two = k1.bilstm_tm_bwd(tm(xp, 0), tm(xp, 1), U, *two, tm(dhs, 0), tm(dhs, 1))
        for d in range(2):
            assert torch.equal(tm(hs, d), two[d]) and torch.equal(tm(cs, d), two[2 + d])
            assert torch.equal(tm(dz, d), dz_two[d])


def test_batch_major_layers_run_k6_on_the_card(cuda, monkeypatch):
    """bilstm_layer / lstm_layer on CUDA tensors launch K6a, and K6b under
    autograd, never the plain versions (remat is ignored on the card), and
    agree with the same layers on the CPU."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    rng = np.random.default_rng(7)
    p = {k: v.numpy() for k, v in tlstm.init_bilstm_params(
        torch.Generator().manual_seed(7), 5, 16).items()}
    x = rng.standard_normal((3, 20, 5)).astype(np.float32)
    g = rng.standard_normal((3, 20, 32)).astype(np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        if dev.type == "cuda":
            for name in ("recurrent_scan_plain", "recurrent_scan_bwd_plain",
                         "recurrent_scan_remat"):
                monkeypatch.setattr(tlstm, name, refuse)
        params = {k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in p.items()}
        xx = torch.from_numpy(x).to(dev).requires_grad_()
        before = dispatch.launch_counts()
        y = tlstm.bilstm_layer(params, xx, train=True, dropout=0.0, remat=True)
        (y.float() * torch.from_numpy(g).to(dev)).sum().backward()
        one = tlstm.lstm_layer({k: v[1] for k, v in params.items()}, xx, reverse=True)
        after = dispatch.launch_counts()
        if dev.type == "cuda":
            assert after["lstm_scan_fwd"] == before["lstm_scan_fwd"] + 2
            assert after["lstm_scan_bwd"] == before["lstm_scan_bwd"] + 1
        out[dev.type] = [t.detach().float().cpu() for t in
                         (y, one, xx.grad, *(params[k].grad for k in ("W", "U", "b")))]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        if i < 2:
            assert float((a - b).abs().max()) <= TOL_K1
        else:
            assert float((a - b).norm() / b.norm()) <= 5e-2, i


def _k1_k2_case(cuda, T, B, H, seed):
    """K1 (c stored) and K2 on seeded inputs at (T, B, H): the kernels'
    streams and dz, and their errors against the plain versions (h and c
    absolute; dz relative to the largest |dz|; dU relative Frobenius)."""
    gen = torch.Generator(cuda).manual_seed(seed)
    bf = torch.bfloat16
    xp = 0.5 * _randn(gen, 2, T, B, 4, H)
    xp[:, :, :, 1, :] += 1.0
    xp = xp.to(bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(seed), 4, H)["U"].to(cuda, bf)
    dhs = (0.1 * _randn(gen, 2, T, B, H)).to(bf)
    streams = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U, store_c=True)
    err_h = max(float((g.float() - w).abs().max()) for g, w in zip(streams, want))
    dz = k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    dz_w = tlstm.bilstm_scan_tm_bwd_plain(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    err_dz = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                 for g, w in zip(dz, dz_w[:2]))
    dU = tlstm.recurrent_weight_grad(streams[0], streams[1], *dz)
    err_dU = float((dU - dz_w[2]).norm() / dz_w[2].norm())
    for g in (*streams, *dz):
        assert torch.isfinite(g.float()).all()
    return (xp, U, dhs), streams, dz, (err_h, err_dz, err_dU)


@pytest.mark.parametrize("T,B,H", [
    (16, 32, 500),                     # the launch shape at short T
    (12, 5, 500), (12, 5, 504),        # h rows 8- and 16-byte aligned
    (10, 1, 64), (10, 16, 64), (10, 17, 64), (10, 64, 64), (6, 256, 64),  # tile edges
    (1900, 1, 500),                    # B=1 at the speech length (B=32-256: the tilings)
    (64, 1, 500), (64, 130, 300), (32, 520, 64), (64, 3, 7),  # a partial tile, 3 launches
])
def test_k1_k2_tensor_core_design_edges(cuda, T, B, H):
    _, streams, dz, (err_h, err_dz, err_dU) = _k1_k2_case(cuda, T, B, H, seed=T * B + H)
    assert streams[0].shape == (T, B, H) and dz[0].shape == (T, B, 4, H)
    assert err_h <= TOL_K1 and err_dz <= TOL_K2_REL and err_dU <= TOL_K2_REL, \
        (err_h, err_dz, err_dU)


@pytest.mark.parametrize("B", [32, 128])
def test_k1_k2_two_launches_are_bit_identical(cuda, B):
    (xp, U, dhs), streams, dz, _ = _k1_k2_case(cuda, 24, B, 500, seed=5)
    again = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    assert all(torch.equal(a, b) for a, b in zip(streams, again))
    dz_again = k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    assert all(torch.equal(a, b) for a, b in zip(dz, dz_again))


def test_k1_k5a_k1_on_one_stream(cuda):
    """Each call zeroes its own barrier counters: K1, then K5a, then K1
    again, back to back on one stream, are each right."""
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    T, B, H = 20, 32, 500
    xp = torch.from_numpy(rng.standard_normal((2, T, B, 4, H)).astype(np.float32)).to(cuda, bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(11), 4, H)["U"].to(cuda, bf)
    first = k1.bilstm_tm_streams(xp[0], xp[1], U)
    one = k1.lstm_tm_streams(xp[1], U[1], reverse=True)
    last = k1.bilstm_tm_streams(xp[0], xp[1], U)
    torch.cuda.synchronize()
    want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U)
    for got in (first, last):
        assert max(float((g.float() - w).abs().max()) for g, w in zip(got, want)) <= TOL_K1
    assert float((one[0].float() - want[1]).abs().max()) <= TOL_K1
    assert torch.equal(one[0], first[1]) and all(torch.equal(a, b) for a, b in zip(first, last))


# ---------------------------------------------------------------- fusion
# The shapes the fusion families give the kernels: K1/K2 at H=100 (the
# late-fusion BiLSTM: 13 eight-unit slices, the last one half empty), K3/K4
# at the fusion presets' K=22, N=35; the frozen encoders' K1 without the c
# store; each fusion model's train step against the plain path on the card.


@pytest.mark.parametrize("T,B", [(40, 32), (40, 1), (40, 33), (1900, 32), (64, 1), (64, 33)])
def test_k1_k2_at_the_fusion_width(cuda, T, B):
    (xp, U, dhs), streams, dz, (err_h, err_dz, err_dU) = _k1_k2_case(cuda, T, B, 100, seed=B)
    assert streams[0].shape == (T, B, 100) and dz[0].shape == (T, B, 4, 100)
    assert err_h <= TOL_K1 and err_dz <= TOL_K2_REL and err_dU <= TOL_K2_REL, \
        (err_h, err_dz, err_dU)
    no_c = k1.bilstm_tm_streams(xp[0], xp[1], U)  # the frozen encoders' launch
    assert all(torch.equal(a, b) for a, b in zip(no_c, streams[:2]))
    again = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    assert all(torch.equal(a, b) for a, b in zip(streams, again))
    dz_again = k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    assert all(torch.equal(a, b) for a, b in zip(dz, dz_again))


def test_k3_k4_at_the_fusion_classes(cuda):
    T, K, N = 400, 22, 35
    lp, args = _ctc_edge(np.random.default_rng(22), T, 7, K, N,
                         [400, 390, 350, 1, 0, 400, 120], [35, 35, 20, 1, 0, 12, 35])
    lp, args = lp.to(cuda), [a.to(cuda) for a in args]
    got = k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)
    want = tctc.ctc_alpha_loss_plain(lp, *args, K - 1, store_alphas=True)
    for g, w in zip(got, want):
        assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_K3_REL
    assert all(torch.equal(a, b) for a, b in
               zip(got, k3.ctc_alpha_loss(lp, *args, K - 1, store_alphas=True)))
    rows, L = torch.arange(7, device=cuda), args[2].long()
    g_phi = -torch.exp(want[1][-1][rows, L] + want[0])
    g_emit = torch.where(L > 0, -torch.exp(want[2][-1][rows, (L - 1).clamp_min(0)] + want[0]),
                         0.0)
    seeded = (lp, *args, K - 1, want[1], want[2], g_phi, g_emit)  # as the loss seeds K4
    d_got = k3.ctc_alpha_bwd(*seeded)
    assert float((d_got - tctc.ctc_alpha_bwd_plain(*seeded)).abs().max()) <= TOL_K4
    own = (lp, *args, K - 1, got[1], got[2], g_phi, g_emit)  # K3's own alphas
    assert torch.equal(k3.ctc_alpha_bwd(*own), k3.ctc_alpha_bwd(*own))


def _fusion_model(name, cuda, finetune=False):
    """A fusion model at test size (T=32, encoder H=16, fusion H=100 for
    late fusion) and a batch of both streams."""
    enc = EncoderConfig(hidden=16)
    if name == "early_fusion":
        cfg = get_preset(name).replace(maxlen=32, batch_size=3, max_label_len=4, encoder=enc)
        sources = None
    else:
        cfg = get_preset(name).replace(maxlen=32, batch_size=3, max_label_len=4,
                                       finetune_encoders=finetune)
        sources = {s: get_preset(s).replace(maxlen=32, encoder=EncoderConfig(hidden=h))
                   for s, h in (("speech", 16), ("skeletal", 12))}
    rng = np.random.default_rng(5)
    batch = {
        "inputs": rng.standard_normal((3, 32, 39)).astype(np.float32),
        "inputs2": rng.standard_normal((3, 32, 20)).astype(np.float32),
        "labels": np.array([[1, 2, -1, -1], [3, 3, 3, -1], [-1, -1, -1, -1]], np.int32),
        "input_length": np.array([30, 20, 25], np.int32),
        "label_length": np.array([2, 3, 0], np.int32),
    }
    model = build_model(cfg, sources, seed=2, device=cuda)
    return model, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["early_fusion", "late_fusion"])
def test_fusion_train_step_on_the_card_matches_the_plain_path(cuda, name, monkeypatch):
    """Loss and gradients of a train-mode step through K1-K4 against the
    same step with the plain versions on the card (same masks): loss 1e-3
    relative, gradients 5e-2 relative Frobenius."""
    model, batch = _fusion_model(name, cuda)
    key = prng.fold_name(prng.root_key(3), "dropout")
    loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), batch, key)
    grads = {k: g.clone() for k, g in grads.items()}
    monkeypatch.setattr(k1, "bilstm_tm_streams", lambda xp0, xp1, U, store_c=False:
                        tlstm.bilstm_scan_tm_plain(xp0, xp1, U, store_c=store_c,
                                                   out_dtype=torch.bfloat16))
    monkeypatch.setattr(k1, "bilstm_tm_bwd", lambda *a: tlstm.bilstm_scan_tm_bwd_plain(*a)[:2])
    monkeypatch.setattr(k3, "ctc_alpha_loss", tctc.ctc_alpha_loss_plain)
    monkeypatch.setattr(k3, "ctc_alpha_bwd", tctc.ctc_alpha_bwd_plain)
    before = dispatch.launch_counts()
    p_loss, p_grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), batch, key)
    assert dispatch.launch_counts() == before  # the plain path launched nothing
    assert abs(float(loss) - float(p_loss)) <= 1e-3 * abs(float(p_loss))
    for k, want in p_grads.items():
        rel = float((grads[k] - want).norm() / want.norm().clamp_min(1e-12))
        assert rel <= 5e-2, (k, rel)


@pytest.mark.parametrize("finetune", [False, True])
def test_late_fusion_step_launch_counts(cuda, finetune):
    """Frozen encoders: K1 5 (4 without the c store), K2 once (the fusion
    layer), K3 1, K4 1; the encoders' weights bit-unchanged. With
    finetune_encoders K2 runs for every layer and the encoders train."""
    model, batch = _fusion_model("late_fusion", cuda, finetune=finetune)
    state = step_lib.create_train_state(model)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    step = step_lib.make_train_step(model)
    dispatch.reset_launch_counts()
    state, m = step(state, batch, prng.root_key(4))
    counts = dispatch.launch_counts()
    assert np.isfinite(float(m["loss"]))
    assert counts == {**{k: 0 for k in counts}, "bilstm_tm_fwd": 5,
                      "bilstm_tm_bwd": 5 if finetune else 1, "ctc_fwd": 1, "ctc_bwd": 1}
    enc = [k for k in start if k.split(".")[0] in ("speech", "skeletal")]
    assert all(torch.equal(state.params[k], start[k]) != finetune for k in enc)


# -------------------------------------------------------------------- rgb
# The rgb family runs K1/K2 at H=512, MAX_H: 64 eight-unit slices a
# direction, 128 cooperative blocks, every warp's K slice full; K2 opts in
# to 230,400 bytes of shared memory at B=256. Its frontend's convs are
# cuDNN's, f32 ones with TF32 off whatever the global flag says.


@pytest.mark.parametrize("T,B", [(12, 1), (12, 8), (12, 32), (12, 256),
                                 (1900, 8), (1900, 256)])  # the rgb length
def test_k1_k2_at_max_h(cuda, T, B):
    (xp, U, dhs), streams, dz, (err_h, err_dz, err_dU) = _k1_k2_case(cuda, T, B, 512, seed=B)
    assert streams[0].shape == (T, B, 512) and dz[0].shape == (T, B, 4, 512)
    assert err_h <= TOL_K1 and err_dz <= TOL_K2_REL and err_dU <= TOL_K2_REL, \
        (err_h, err_dz, err_dU)
    again = k1.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
    assert all(torch.equal(a, b) for a, b in zip(streams, again))
    dz_again = k1.bilstm_tm_bwd(xp[0], xp[1], U, *streams, dhs[0], dhs[1])
    assert all(torch.equal(a, b) for a, b in zip(dz, dz_again))


def test_cnn_frontend_f32_on_the_card_matches_the_cpu(cuda):
    """The preset's frontend (60x60 frames, 16/32/48 channels) in f32 with
    the global cuDNN TF32 flag ON: features within 1e-5 and the conv
    kernels' gradients within 1e-4 relative Frobenius of the CPU's, which
    TF32 (10 mantissa bits) would miss by orders of magnitude."""
    from mgr_tpu_torch.models import layers

    cnn = get_preset("rgb").cnn
    gen = torch.Generator().manual_seed(8)
    params = layers.init_cnn(gen, cnn)
    for i, c in enumerate(cnn.channels):
        params[f"bias_{i}"] = 0.1 * torch.randn((c,), generator=gen)
    x = (torch.randint(0, 256, (2, 8, 60, 60, 1), generator=gen) - 128.0) / 255.0
    tangent = torch.randn((2, 8, layers.cnn_output_dim(cnn)), generator=gen)
    out = {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in (cuda, torch.device("cpu")):
            p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
            feats = layers.cnn_frontend(p, x.to(dev), cnn, torch.float32)
            grads = torch.autograd.grad((feats * tangent.to(dev)).sum(), list(p.values()))
            out[dev.type] = (feats.detach().cpu(), [g.cpu() for g in grads])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.backends.cudnn.allow_tf32 == saved
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-5
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - w).norm() / w.norm()) <= 1e-4


def test_rgb_train_step_on_the_card_matches_the_plain_path(cuda, monkeypatch):
    """The rgb preset at T=40, B=2 (the full CNN, BiLSTM(512)x2, remat on):
    one step launches K1 2, K2 2, K3 1, K4 1; its loss and gradients
    (cnn.* included) through K1-K4 against the same step with the plain
    versions on the card: loss 1e-3 relative, gradients 5e-2 relative
    Frobenius."""
    cfg = get_preset("rgb").replace(maxlen=40, batch_size=2)
    model = build_model(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(6)
    batch = {
        "inputs": ((rng.integers(0, 256, (2, 40, 60, 60, 1)) - 128.0) / 255.0).astype(
            np.float32),
        "labels": np.array([[1, 2] + [-1] * 26, [3, 3, 3] + [-1] * 25], np.int32),
        "input_length": np.array([38, 38], np.int32),
        "label_length": np.array([2, 3], np.int32),
    }
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    dispatch.reset_launch_counts()
    loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), batch, None)
    counts = dispatch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "bilstm_tm_fwd": 2, "bilstm_tm_bwd": 2,
                      "ctc_fwd": 1, "ctc_bwd": 1}
    grads = {k: g.clone() for k, g in grads.items()}
    monkeypatch.setattr(k1, "bilstm_tm_streams", lambda xp0, xp1, U, store_c=False:
                        tlstm.bilstm_scan_tm_plain(xp0, xp1, U, store_c=store_c,
                                                   out_dtype=torch.bfloat16))
    monkeypatch.setattr(k1, "bilstm_tm_bwd", lambda *a: tlstm.bilstm_scan_tm_bwd_plain(*a)[:2])
    monkeypatch.setattr(k3, "ctc_alpha_loss", tctc.ctc_alpha_loss_plain)
    monkeypatch.setattr(k3, "ctc_alpha_bwd", tctc.ctc_alpha_bwd_plain)
    p_loss, p_grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), batch, None)
    assert dispatch.launch_counts() == counts  # the plain path launched nothing
    assert abs(float(loss) - float(p_loss)) <= 1e-3 * abs(float(p_loss))
    assert {f"cnn.conv_{i}" for i in range(3)} <= set(p_grads)
    for k, want in p_grads.items():
        rel = float((grads[k] - want).norm() / want.norm().clamp_min(1e-12))
        assert rel <= 5e-2, (k, rel)


@pytest.mark.parametrize("name,B", [("speech", 128), ("rgb", 16)])
def test_train_step_k2_tiling_by_batch(cuda, name, B):
    """One train step at the preset's widths (speech H=500, rgb H=512) and
    the benchmark cells' batches, at T=40: K1 and K2 twice each, every
    launch grouped at B=128 and none at B=16; the loss finite."""
    cfg = get_preset(name).replace(maxlen=40, batch_size=B)
    model = build_model(cfg, seed=7, device=cuda)
    rng = np.random.default_rng(8)
    if name == "rgb":
        x = ((rng.integers(0, 256, (B, 40, 60, 60, 1)) - 128.0) / 255.0).astype(np.float32)
    else:
        x = rng.standard_normal((B, 40, cfg.num_feats)).astype(np.float32)
    labels = np.full((B, cfg.max_label_len), -1, np.int32)
    labels[:, :3] = rng.integers(0, cfg.nb_classes - 1, size=(B, 3))
    batch = {"inputs": x, "labels": labels,
             "input_length": np.full((B,), 38, np.int32),
             "label_length": np.full((B,), 3, np.int32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    state = step_lib.create_train_state(model)
    step = step_lib.make_train_step(model)
    dispatch.reset_launch_counts()
    state, m = step(state, batch, prng.root_key(5))
    assert np.isfinite(float(m["loss"]))
    counts, grouped = dispatch.launch_counts(), dispatch.grouped_counts()
    assert counts["bilstm_tm_bwd"] == counts["bilstm_tm_fwd"] == 2
    assert grouped["bilstm_tm_bwd"] == grouped["bilstm_tm_fwd"] == (2 if B > 32 else 0)


@pytest.mark.parametrize("name,B,launches", [
    ("speech", 128, 2), ("late_fusion", 64, 5), ("speech", 1, 2)])
def test_decode_step_k1_tiling_by_batch(cuda, name, B, launches):
    """One decode call at the preset's widths (speech H=500; late fusion's
    towers at H=500 and 300 and its fusion layer at 100) and the serving
    cells' batches, at T=40: every K1 launch grouped at B=128 and B=64, none
    at B=1."""
    cfg = get_preset(name).replace(maxlen=40)
    model = build_model(cfg, seed=9, device=cuda)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, 40, cfg.num_feats)).astype(np.float32)
    if name == "late_fusion":
        x = (x, rng.standard_normal((B, 40, 20)).astype(np.float32))
    step = step_lib.make_decode_step(model, threshold=0.5)
    dispatch.reset_launch_counts()
    best, emit = step(x)
    assert best.shape == emit.shape and best.shape[0] == B
    assert dispatch.launch_counts()["bilstm_tm_fwd"] == launches
    assert dispatch.grouped_counts()["bilstm_tm_fwd"] == (launches if B > 32 else 0)


@contextlib.contextmanager
def _global_tf32_on():
    """cuBLAS's global TF32 flag on for the block, restored after it: the
    featurizers' f32 products must not take it."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = saved
    assert flags.allow_tf32 == saved


def test_mfcc_on_the_card_matches_the_cpu(cuda):
    """A 95 s, 16 kHz waveform (9,498 frames) and a batch of short ones,
    with the global TF32 flag on: within the MFCC tolerance (rtol 1e-4,
    atol 1e-3; cuFFT against the CPU's FFT) of the CPU's features."""
    from mgr_tpu_torch.ops import mfcc

    rng = np.random.default_rng(11)
    sig = torch.from_numpy((3000 * rng.standard_normal(95 * 16000)).astype(np.float32))
    sigs = torch.from_numpy((3000 * rng.standard_normal((3, 4000))).astype(np.float32))
    with _global_tf32_on():
        got = mfcc.mfcc_39(sig.to(cuda)).cpu()
        got_b = mfcc.batch_mfcc_39(sigs.to(cuda)).cpu()
    assert got.shape == (9498, 39)
    torch.testing.assert_close(got, mfcc.mfcc_39(sig), rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got_b, mfcc.batch_mfcc_39(sigs), rtol=1e-4, atol=1e-3)


def test_kinematics_on_the_card_match_the_cpu(cuda):
    """1,900 frames of integer Kinect tracks: the floored and truncated
    columns exactly, the rest within 1e-5, the extra columns too."""
    from mgr_tpu_torch.ops import kinematics

    rng = np.random.default_rng(12)
    joints = {}
    for name in ("lh", "rh", "le", "re", "hip", "shc"):
        steps = rng.integers(-6, 7, size=(1900, 2)) * (rng.random((1900, 1)) < 0.5)
        joints[name] = torch.from_numpy(
            np.clip(rng.integers(100, 400, size=2) + np.cumsum(steps, 0), 0, 479).astype(np.float32))
    on_card = {k: v.to(cuda) for k, v in joints.items()}
    got, want = kinematics.skeletal_features(on_card).cpu(), kinematics.skeletal_features(joints)
    assert torch.equal(got[:, 4:6], want[:, 4:6])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    extra_got, extra_want = kinematics.extra_features(on_card), kinematics.extra_features(joints)
    for k, w in extra_want.items():
        torch.testing.assert_close(extra_got[k].cpu(), w, rtol=0, atol=1e-5)


def test_roi_crop_resize_on_the_card_matches_the_cpu(cuda):
    """300 uint8 frames of 480 x 640 (more than one chunk) with boxes that
    shrink, grow and fall back, the global TF32 flag on: within 1e-3 of the
    CPU on the 0-255 scale (TF32 would be ~0.1 off)."""
    from mgr_tpu_torch.ops import image

    rng = np.random.default_rng(13)
    T = 300
    video = torch.from_numpy(rng.integers(0, 256, size=(T, 480, 640)).astype(np.uint8))
    hip = torch.from_numpy(np.stack([rng.integers(0, 640, T), rng.integers(200, 480, T)],
                                    1).astype(np.float32))
    shc = torch.from_numpy(np.stack([hip[:, 0].numpy(), hip[:, 1].numpy()
                                     - rng.integers(50, 250, T)], 1).astype(np.float32))
    valid = torch.from_numpy(rng.random(T) < 0.8)
    with _global_tf32_on():
        got = image.extract_upper_body_video(video.to(cuda), hip.to(cuda), shc.to(cuda), 60,
                                             valid.to(cuda)).cpu()
    want = image.extract_upper_body_video(video, hip, shc, 60, valid)
    assert got.shape == (T, 60, 60, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_fit_device_path_on_the_card_gives_the_host_paths_bits(cuda):
    """fit on the corpus held on the card (rows gathered there) against
    fit on host batches, from the same weights, noise and dropout on:
    the same parameters bit for bit and the same launches of K1-K4."""
    from mgr_tpu_torch.data.batcher import Batcher
    from mgr_tpu_torch.train.loop import fit

    cfg = get_preset("speech").replace(maxlen=48, batch_size=4, max_label_len=6,
                                       encoder=EncoderConfig(hidden=32))
    rng = np.random.default_rng(9)
    n = 12
    feats = rng.standard_normal((n, cfg.maxlen, cfg.num_feats)).astype(np.float32)
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=n).astype(np.int32)
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    in_len = np.full((n,), cfg.maxlen - cfg.ctc.trim_frames, np.int32)
    ids = list(range(n))
    data = Batcher(feats, labels, lab_len, in_len, ids, train_ids=ids[:8], val_ids=ids[8:])
    model = build_model(cfg, seed=4, device=cuda)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = {}
    for on in (True, False):
        model.load_state_dict(init)
        dispatch.reset_launch_counts()
        res = fit(model, data, epochs=2, device_data=on)
        got[on] = ({k: v.detach().clone() for k, v in res.state.params.items()},
                   dispatch.launch_counts())
    assert got[True][1] == got[False][1] and got[True][1]["bilstm_tm_bwd"] == 8
    assert all(torch.equal(got[True][0][k], v) for k, v in got[False][0].items())


def test_example_corpus_trains_through_the_kernels_and_decodes(cuda, tmp_path):
    """The example's corpus, written by the port's ``synthetic``, trained
    for a few epochs on the card (fit launches K1-K4), its validation
    split decoded to an MLF."""
    from mgr_tpu_torch.data import datasets
    from mgr_tpu_torch.decode import Decoder, read_mlf
    from mgr_tpu_torch.examples import synthetic_end_to_end as example
    from mgr_tpu_torch.train.loop import fit

    csv_path, label_file, labels = example.make_corpus(str(tmp_path))
    cfg = example.example_config()
    data = datasets.build_skeletal_dataset(csv_path, label_file, cfg)
    model = build_model(cfg, device=cuda)
    dispatch.reset_launch_counts()
    res = fit(model, data, epochs=3)
    launches = dispatch.launch_counts()
    assert res.epochs_run == 3 and np.isfinite(res.history[-1]["train_loss"])
    assert all(launches[k] > 0 for k in ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd"))
    dec = Decoder.for_model(model, "skeletal")
    decoded = dec.decode_batches(data.epoch(cfg.batch_size, train=False), use_lengths=True)
    dec.write_mlf(str(tmp_path / "sk.mlf"), decoded)
    assert sorted(read_mlf(tmp_path / "sk.mlf")) == sorted(
        f"Sample{fid:05d}" for fid in data.val_ids)
