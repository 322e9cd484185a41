"""The plain recurrence (``ops/lstm.py``: ``lstm_scan_tm_plain``, its adjoint
``lstm_scan_tm_bwd_plain`` and the cell the h-sharded scan shares) held bit
for bit to the per-gate loop it was written as: one hard-sigmoid call a
gate, each stream cast inside the walk.

The plain versions are the references K1/K2 and K5a/K5b are held to, and
the CPU path of every train step, so the walk was made faster by casting
each stream once and taking the three hard-sigmoid gates (and their
slopes) in one pass. Every value is still produced by the same
elementwise operation on the same operands, so the results must be
equal, not close; tanh keeps its per-gate, per-step calls, since a
vectorised tanh may round a tensor's tail elements another way.
"""

from __future__ import annotations

import pytest
import torch

from mgr_tpu_torch.ops import lstm as tlstm

torch.set_num_threads(1)


def _gate_loop_cell(z, c):
    H = c.shape[-1]
    i = tlstm.hard_sigmoid(z[..., 0 * H:1 * H])
    f = tlstm.hard_sigmoid(z[..., 1 * H:2 * H])
    g = torch.tanh(z[..., 2 * H:3 * H])
    o = tlstm.hard_sigmoid(z[..., 3 * H:4 * H])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _gate_loop_fwd(xp, U1, reverse):
    T, B, _, H = xp.shape
    cd = xp.dtype
    Uc = U1.to(cd).reshape(H, 4 * H)
    hs, cs = torch.empty((T, B, H), dtype=cd), torch.empty((T, B, H), dtype=cd)
    h = c = torch.zeros((B, H))
    for s in range(T):
        t = T - 1 - s if reverse else s
        z = xp[t].float().reshape(B, 4 * H) + tlstm.matmul_f32(h.to(cd), Uc)
        h, c = _gate_loop_cell(z, c)
        hs[t], cs[t] = h.to(cd), c.to(cd)
    return hs, cs


def _gate_loop_dz(xp, U1, hs, cs, dhs, reverse):
    T, B, _, H = xp.shape
    cd = xp.dtype
    Uc = U1.to(cd).reshape(H, 4 * H)
    dz = torch.empty((T, B, 4 * H), dtype=cd)
    dh_c = dc_c = torch.zeros((B, H))
    zero = torch.zeros((B, H), dtype=cd)
    for s in range(T):
        t = s if reverse else T - 1 - s
        t_pre = t + 1 if reverse else t - 1
        has_pre = 0 <= t_pre < T
        h_pre = hs[t_pre].to(cd) if has_pre else zero
        c_pre = cs[t_pre].float() if has_pre else zero.float()
        z = xp[t].float().reshape(B, 4 * H) + tlstm.matmul_f32(h_pre, Uc)
        z_i, z_f, z_g, z_o = (z[:, g * H:(g + 1) * H] for g in range(4))
        i, f, o = tlstm.hard_sigmoid(z_i), tlstm.hard_sigmoid(z_f), tlstm.hard_sigmoid(z_o)
        g_ = torch.tanh(z_g)
        tanh_c = torch.tanh(cs[t].float())
        dh = dhs[t].float() + dh_c
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dz_t = torch.cat([
            (dc * g_) * tlstm.hard_sigmoid_grad(z_i),
            (dc * c_pre) * tlstm.hard_sigmoid_grad(z_f),
            (dc * i) * (1.0 - g_ * g_),
            (dh * tanh_c) * tlstm.hard_sigmoid_grad(z_o),
        ], dim=1).to(cd)
        dz[t] = dz_t
        dh_c = tlstm.matmul_f32(dz_t, Uc.t())
        dc_c = dc * f
    return dz.reshape(T, B, 4, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_equals_the_gate_loop(dtype, reverse):
    """Forward streams, dz and dU bit for bit; pre-activations scaled past
    the hard sigmoid's ends (|z| > 2.5) so its clamps and zero slopes
    are exercised."""
    g = torch.Generator().manual_seed(3)
    T, B, H = 19, 3, 7
    xp = (torch.randn((T, B, 4, H), generator=g) * 3).to(dtype)
    U = torch.randn((H, 4, H), generator=g) * 0.5
    dhs = torch.randn((T, B, H), generator=g).to(dtype)
    hs, cs = tlstm.lstm_scan_tm_plain(xp, U, reverse=reverse, store_c=True, out_dtype=dtype)
    want_hs, want_cs = _gate_loop_fwd(xp, U, reverse)
    assert torch.equal(hs, want_hs) and torch.equal(cs, want_cs)
    dz, dU = tlstm.lstm_scan_tm_bwd_plain(xp, U, hs, cs, dhs, reverse=reverse)
    want_dz = _gate_loop_dz(xp, U, hs, cs, dhs, reverse)
    assert torch.equal(dz, want_dz)
    assert torch.equal(dU, tlstm.lstm_weight_grad(hs, want_dz, reverse=reverse))


def test_cell_equals_the_gate_loop():
    """The cell of both directions at once, as the h-sharded scan steps it."""
    g = torch.Generator().manual_seed(4)
    z = torch.randn((2, 3, 4 * 5), generator=g) * 3
    c = torch.randn((2, 3, 5), generator=g)
    got, want = tlstm._cell(z, c), _gate_loop_cell(z, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
