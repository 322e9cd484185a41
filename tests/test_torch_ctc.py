"""The port's CTC loss (mgr_tpu_torch.ops.ctc, kernel K3's plain version)
held against the JAX package and two independent oracles.

Tolerance 1e-4 (absolute and relative) for every comparison: the losses
are f32 logaddexp chains over T steps; the JAX tests use the same bound.
Oracles: ``mgr_tpu.ops.ctc.ctc_loss`` (XLA scan), ``pallas_ctc_loss``
in interpret mode (time-major), the NumPy lattice
``ctc_loss_reference``, and ``torch.nn.functional.ctc_loss`` (used here
only, never by the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mgr_tpu.ops import ctc as jctc
from mgr_tpu.ops import pallas_kernels as pk
from mgr_tpu_torch.kernels import ctc as k3
from mgr_tpu_torch.ops import ctc as tctc
from mgr_tpu_torch.ops import dispatch

torch.set_num_threads(1)

TOL = 1e-4


def _case(seed, B=4, T=24, K=6, N=4):
    """Ragged batch: one zero-length label, repeated labels, and input
    lengths below T so frames t >= len must be frozen."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, K)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    lab_len = rng.integers(1, N + 1, size=B).astype(np.int32)
    lab_len[0] = 0
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        labels[b, : lab_len[b]] = rng.integers(0, K - 1, size=lab_len[b])
    labels[1] = (np.arange(N) // 2 + 2) % (K - 1)  # 2 2 3 3 ..: repeats need a blank between
    lab_len[1] = N
    in_len = rng.integers(2 * N + 1, T + 1, size=B).astype(np.int32)
    in_len[-1] = T
    return logits, lp, labels, in_len, lab_len


def _port(lp, labels, in_len, lab_len, **kw):
    return tctc.ctc_loss(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(in_len), torch.from_numpy(lab_len), **kw,
    ).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_xla_scan(seed):
    _, lp, labels, in_len, lab_len = _case(seed)
    want = jctc.ctc_loss(jnp.asarray(lp), jnp.asarray(labels),
                         jnp.asarray(in_len), jnp.asarray(lab_len), backend="xla")
    np.testing.assert_allclose(_port(lp, labels, in_len, lab_len),
                               np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_pallas_interpret_time_major(seed):
    _, lp, labels, in_len, lab_len = _case(seed)
    lp_tm = np.ascontiguousarray(lp.transpose(1, 0, 2))
    want = pk.pallas_ctc_loss(
        jnp.asarray(lp_tm), jnp.asarray(labels), jnp.asarray(in_len),
        jnp.asarray(lab_len), interpret=True, time_major=True,
    )
    got = _port(lp_tm, labels, in_len, lab_len, time_major=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_matches_numpy_lattice_reference():
    _, lp, labels, in_len, lab_len = _case(5, B=5, T=30, N=5)
    want = jctc.ctc_loss_reference_batch(lp, labels, in_len, lab_len)
    np.testing.assert_allclose(_port(lp, labels, in_len, lab_len),
                               want, rtol=TOL, atol=TOL)


def test_matches_torch_ctc_loss_oracle():
    _, lp, labels, in_len, lab_len = _case(6)
    K = lp.shape[-1]
    want = F.ctc_loss(
        torch.from_numpy(lp).transpose(0, 1), torch.from_numpy(labels).clamp_min(0),
        torch.from_numpy(in_len).long(), torch.from_numpy(lab_len).long(),
        blank=K - 1, reduction="none",
    ).numpy()
    np.testing.assert_allclose(_port(lp, labels, in_len, lab_len),
                               want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("trim", [0, 2])
def test_from_logits_time_major_matches_jax(trim):
    logits, _, labels, in_len, lab_len = _case(7, T=26)
    in_len = np.minimum(in_len, 26 - trim).astype(np.int32)
    logits_tm = np.ascontiguousarray(logits.transpose(1, 0, 2))
    want = jctc.ctc_loss_from_logits(
        jnp.asarray(logits_tm), jnp.asarray(labels), jnp.asarray(in_len),
        jnp.asarray(lab_len), trim_frames=trim, time_major=True,
    )
    got = tctc.ctc_loss_from_logits(
        torch.from_numpy(logits_tm), torch.from_numpy(labels),
        torch.from_numpy(in_len), torch.from_numpy(lab_len),
        trim_frames=trim, time_major=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_frames_past_input_length_do_not_count():
    _, lp, labels, in_len, lab_len = _case(8)
    noisy = lp.copy()
    for b, n in enumerate(in_len):
        noisy[b, n:] = np.log(np.full(lp.shape[-1], 1.0 / lp.shape[-1]))
    np.testing.assert_array_equal(_port(lp, labels, in_len, lab_len),
                                  _port(noisy, labels, in_len, lab_len))


def test_cpu_tensor_takes_the_plain_version():
    _, lp, labels, in_len, lab_len = _case(9)
    lp_tm = torch.from_numpy(np.ascontiguousarray(lp.transpose(1, 0, 2)))
    args = [torch.from_numpy(a) for a in (labels, in_len, lab_len)]
    before = dispatch.launch_counts()["ctc_fwd"]
    got = k3.ctc_alpha_loss(lp_tm, *args, lp.shape[-1] - 1)
    want = tctc.ctc_alpha_loss_plain(lp_tm, *args, lp.shape[-1] - 1)
    assert torch.equal(got, want)
    assert dispatch.launch_counts()["ctc_fwd"] == before


# ---- the adjoint (kernel K4's plain version) and the autograd Function ----
# Gradients are compared at 1e-4 absolute: d log_probs entries are
# posterior occupancies in [-1, 1] from f32 exp / logaddexp chains.


def _grad_case(seed):
    logits, lp, labels, in_len, lab_len = _case(seed, B=5, T=20, K=7, N=5)
    labels[2] = [3, 3, 3, 1, 1]  # a run of repeated labels ...
    lab_len[2] = 5               # ... at the full label length N
    in_len[3] = 11               # frames past the length: zero gradient
    return logits, lp, labels, in_len, lab_len


def _port_grad(lp, labels, in_len, lab_len, weights):
    x = torch.from_numpy(lp).requires_grad_()
    loss = tctc.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, in_len, lab_len)),
                         time_major=True)
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 3])
def test_grad_matches_pallas_interpret(seed):
    _, lp, labels, in_len, lab_len = _grad_case(seed)
    w = np.random.default_rng(seed).uniform(0.5, 2.0, size=lp.shape[0]).astype(np.float32)
    lp_tm = np.ascontiguousarray(lp.transpose(1, 0, 2))

    def jloss(x):
        per = pk.pallas_ctc_loss(x, jnp.asarray(labels), jnp.asarray(in_len),
                                 jnp.asarray(lab_len), interpret=True, time_major=True)
        return jnp.sum(per * w), per

    (_, want_loss), want = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lp_tm))
    got_loss, got = _port_grad(lp_tm, labels, in_len, lab_len, w)
    np.testing.assert_allclose(got_loss, np.asarray(want_loss), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    for b, n in enumerate(in_len):
        assert not got[n:, b].any()  # frames t >= len: exactly zero


def test_grad_matches_torch_ctc_loss():
    """Second oracle: F.ctc_loss's gradient, taken through log_softmax
    (its backward assumes normalised inputs, so the two agree on the
    logits' gradient, not on the log-probs')."""
    logits, _, labels, in_len, lab_len = _grad_case(4)
    l_tm = torch.from_numpy(np.ascontiguousarray(logits.transpose(1, 0, 2)))
    a = l_tm.clone().requires_grad_()
    b = l_tm.double().clone().requires_grad_()
    tctc.ctc_loss(torch.log_softmax(a, -1), *(torch.from_numpy(x) for x in
                  (labels, in_len, lab_len)), time_major=True).sum().backward()
    F.ctc_loss(torch.log_softmax(b, -1), torch.from_numpy(np.maximum(labels, 0)).long(),
               torch.from_numpy(in_len).long(), torch.from_numpy(lab_len).long(),
               blank=logits.shape[-1] - 1, reduction="sum").backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=TOL, rtol=0)


def test_alpha_store_is_frozen_past_the_length():
    _, lp, labels, in_len, lab_len = _grad_case(5)
    lp_tm = torch.from_numpy(np.ascontiguousarray(lp.transpose(1, 0, 2)))
    args = [torch.from_numpy(a) for a in (labels, in_len, lab_len)]
    loss, a_phi, a_emit = k3.ctc_alpha_loss(lp_tm, *args, lp.shape[-1] - 1, store_alphas=True)
    T, B, N = a_emit.shape
    assert a_phi.shape == (T, B, N + 1)
    assert torch.equal(loss, k3.ctc_alpha_loss(lp_tm, *args, lp.shape[-1] - 1))
    for b, n in enumerate(in_len):
        assert torch.equal(a_phi[n - 1:, b], a_phi[n - 1, b].expand(T - n + 1, -1))
        assert torch.equal(a_emit[n - 1:, b], a_emit[n - 1, b].expand(T - n + 1, -1))
    rows = torch.arange(B)
    L = args[2].long()
    ends = torch.logaddexp(a_phi[-1][rows, L],
                           torch.where(L > 0, a_emit[-1][rows, (L - 1).clamp_min(0)], -1e5))
    assert torch.equal(loss, -ends)


def test_no_grad_takes_the_loss_only_launch(monkeypatch):
    """Under no_grad (the eval path) the loss runs without the alpha store."""
    _, lp, labels, in_len, lab_len = _grad_case(6)
    seen = []
    real = k3.ctc_alpha_loss
    monkeypatch.setattr(k3, "ctc_alpha_loss", lambda *a, **k: seen.append(k) or real(*a, **k))
    x = torch.from_numpy(lp).requires_grad_()
    with torch.no_grad():
        tctc.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, in_len, lab_len)))
    tctc.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, in_len, lab_len)))
    assert seen == [{}, {"store_alphas": True}]


def test_no_label_columns_score_the_all_blank_path():
    """N = 0 (labels (B, 0)): the loss is the all-blank path's, and its
    gradient is -1 at the blank on every valid frame, 0 elsewhere."""
    rng = np.random.default_rng(7)
    T, B, K = 9, 3, 5
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((T, B, K)).astype(np.float32)),
                           -1).requires_grad_()
    in_len = torch.tensor([9, 4, 0], dtype=torch.int32)
    args = (torch.zeros((B, 0), dtype=torch.int32), in_len, torch.zeros(B, dtype=torch.int32))
    loss = tctc.ctc_loss(lp, *args, time_major=True)
    valid = torch.arange(T)[:, None] < in_len[None, :]
    want = -(lp[:, :, K - 1] * valid).sum(0)
    np.testing.assert_allclose(loss.detach().numpy(), want.detach().numpy(), rtol=TOL, atol=TOL)
    loss.sum().backward()
    grad = torch.zeros((T, B, K))
    grad[:, :, K - 1] = -valid.float()
    np.testing.assert_allclose(lp.grad.numpy(), grad.numpy(), atol=TOL)


def test_k4_layout_keeps_a_pitched_view_and_copies_the_rest():
    """K4 reads alpha rows alpha_pitch(w) floats apart: K3's pitched views
    pass through as they are; alphas of another layout (the plain
    version's, contiguous) are copied into that layout, values unchanged."""
    assert [k3.alpha_pitch(w) for w in (0, 1, 4, 150, 151)] == [0, 4, 4, 152, 152]
    pitched = torch.zeros((2, 3, 152))[..., :151]
    assert k3._pitched(pitched) is pitched
    plain = torch.randn((2, 3, 151))
    copied = k3._pitched(plain)
    assert copied.stride() == (3 * 152, 152, 1) and torch.equal(copied, plain)
