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
