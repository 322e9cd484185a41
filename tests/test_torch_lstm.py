"""The port's BiLSTM (mgr_tpu_torch.ops.lstm, kernel K1's plain version)
held against the JAX package on the same parameters and inputs.

Tolerances:
  * plain f32 recurrence vs ``mgr_tpu.ops.lstm.bilstm_layer_tm`` with
    ``compute_dtype=float32`` (the XLA path): 1e-5 (f32 sums in another
    order).
  * bf16 recurrence vs ``pallas_bilstm_tm(interpret=True)``: 3e-2, as in
    tests/test_pallas.py (bf16 h stream; one bf16 ulp of h is ~4e-3).
  * bf16 adjoint (K2's plain version, and the autograd Function) vs
    ``jax.vjp`` of ``pallas_bilstm_tm(interpret=True)``: dxp within 1e-2
    of the largest |dxp|, dU within 1e-3 relative Frobenius. Both round
    the same values to bf16 at the same places and differ only in the
    order of f32 sums (2e-7 measured at these sizes). The bounds leave
    room for a sum that lands on the other side of a bf16 rounding (one
    ulp, 2^-8 relative, of one entry); a wrong formula is off by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mgr_tpu.ops import lstm as jlstm
from mgr_tpu.ops import pallas_kernels as pk
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm

torch.set_num_threads(1)

T, B, F_IN, H = 24, 3, 5, 8
TOL_F32 = 1e-5
TOL_BF16 = 3e-2
TOL_DXP_REL = 1e-2
TOL_DU_REL = 1e-3


def _jax_params(seed=0, in_dim=F_IN, hidden=H):
    p = jlstm.init_bilstm_params(jax.random.key(seed), in_dim, hidden)
    return {k: np.array(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(seed=1, shape=(T, B, F_IN)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_hard_sigmoid_is_keras_not_torch():
    x = np.linspace(-4, 4, 81).astype(np.float32)
    got = tlstm.hard_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlstm.hard_sigmoid(jnp.asarray(x))))
    # torch's hardsigmoid is x/6 + 1/2 (saturating at +-3): a different curve.
    torch_hs = F.hardsigmoid(torch.from_numpy(x)).numpy()
    assert np.abs(got - torch_hs).max() > 0.05
    assert got[np.searchsorted(x, 1.0)] == pytest.approx(0.7)


def test_gate_order_and_gate_blocked_columns():
    # One step, U = 0: z = xp, so each gate reads its own column g*H + j.
    zi, zf, zg, zo = 0.5, -1.0, 0.3, 2.0
    xp = torch.zeros((1, 1, 4, 2))
    xp[0, 0, :, 1] = torch.tensor([zi, zf, zg, zo])  # unit 1 only
    U = torch.zeros((2, 2, 4, 2))
    hs0, hs1 = tlstm.bilstm_scan_tm_plain(xp, xp.clone(), U)

    def hsig(v):
        return min(max(0.2 * v + 0.5, 0.0), 1.0)

    c = hsig(zi) * np.tanh(zg)  # f * c_prev vanishes: c_prev = 0
    want = hsig(zo) * np.tanh(c)
    for hs in (hs0, hs1):
        assert float(hs[0, 0, 1]) == pytest.approx(want, rel=1e-6)
        assert float(hs[0, 0, 0]) == pytest.approx(hsig(0.0) * np.tanh(0.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_bilstm_layer_f32_matches_xla(seed):
    p = _jax_params(seed)
    x = _x(seed + 10)
    want = jlstm.bilstm_layer_tm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        compute_dtype=jnp.float32,
    )
    got = tlstm.bilstm_layer_tm(_torch(p), torch.from_numpy(x),
                                compute_dtype=torch.float32)
    assert got.shape == (T, B, 2 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)


def test_bilstm_layer_bf16_matches_xla_bf16():
    p = _jax_params(3)
    x = _x(4)
    want = jlstm.bilstm_layer_tm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        compute_dtype=jnp.bfloat16,
    )
    got = tlstm.bilstm_layer_tm(_torch(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=TOL_BF16, rtol=0,
    )


@pytest.mark.parametrize("hidden", [8, 7])
def test_recurrence_bf16_matches_pallas_interpret(hidden):
    rng = np.random.default_rng(5)
    xp0, xp1 = (rng.standard_normal((T, B, 4, hidden)).astype(np.float32)
                for _ in range(2))
    U = _jax_params(6, hidden=hidden)["U"]
    jh0, jh1 = pk.pallas_bilstm_tm(
        jnp.asarray(xp0, jnp.bfloat16), jnp.asarray(xp1, jnp.bfloat16),
        jnp.asarray(U), interpret=True,
    )
    bf = torch.bfloat16
    th0, th1 = tlstm.bilstm_scan_tm_plain(
        torch.from_numpy(xp0).to(bf), torch.from_numpy(xp1).to(bf),
        torch.from_numpy(U).to(bf),
    )
    np.testing.assert_allclose(th0.numpy(), np.asarray(jh0), atol=TOL_BF16, rtol=0)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=TOL_BF16, rtol=0)


def test_projection_adds_bias_in_f32_before_rounding():
    # JAX: (bf16(x) . bf16(W) summed in f32) + b, THEN cast to bf16
    # (mgr_tpu/ops/lstm.py:469-472). A bf16 matmul rounds before the bias.
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 4, F_IN)).astype(np.float32)
    W = rng.standard_normal((F_IN, 4, H)).astype(np.float32)
    b = (1.0 + rng.standard_normal((4, H)) * 1e-2).astype(np.float32)
    xc, Wc = jnp.asarray(x, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16)
    want = (jnp.einsum("tbf,fgh->tbgh", xc, Wc, preferred_element_type=jnp.float32)
            + jnp.asarray(b)[None, None]).astype(jnp.bfloat16)
    got = tlstm.input_projection(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b), torch.bfloat16
    )
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    bf = torch.bfloat16
    rounded_first = (
        torch.from_numpy(x).to(bf).reshape(-1, F_IN)
        @ torch.from_numpy(W).to(bf).reshape(F_IN, 4 * H)
    ) + torch.from_numpy(b).reshape(4 * H).to(bf)
    assert (rounded_first.float().numpy().reshape(want.shape) != want).any()


def _projection_by_parts(xc, Wc, b, compute_dtype, gate_scale):
    """The projection as separate autograd nodes: ``matmul_f32`` (one, or
    one a gate), the f32 bias add, the rounding to the compute dtype."""
    F, _, H = Wc.shape
    if gate_scale is None:
        xp = tlstm.matmul_f32(xc, Wc.reshape(F, 4 * H))
    else:
        xp = torch.cat([tlstm.matmul_f32(xc * gate_scale[g], Wc[:, g, :]) for g in range(4)],
                       dim=-1)
    return (xp + b.reshape(4 * H)).to(compute_dtype).reshape(*xc.shape[:-1], 4, H)


@pytest.mark.parametrize("per_gate", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_projection_backward_matches_the_composition_of_parts(per_gate, dtype, monkeypatch):
    """``input_projection``'s one autograd node gives the gradients of the
    composition of its parts: dx and dW bit for bit, db to the order of
    f32 sums; its backward receives the cotangent in the compute dtype."""
    rng = np.random.default_rng(21)
    f_in = 40
    x = torch.from_numpy(rng.standard_normal((T, B, f_in)).astype(np.float32)).to(dtype)
    W = torch.from_numpy(rng.standard_normal((f_in, 4, H)).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.standard_normal((4, H)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((T, B, 4, H)).astype(np.float32)).to(dtype)
    keep = torch.from_numpy(rng.random((4, B, f_in)) < 0.6)
    scale = (keep / 0.6).to(dtype) if per_gate else None

    seen = []
    backward = tlstm._Projection.backward

    def spy(ctx, cot):
        seen.append(cot.dtype)
        return backward(ctx, cot)

    monkeypatch.setattr(tlstm._Projection, "backward", staticmethod(spy))

    def grads(fn):
        xs, Ws, bs = (t.clone().requires_grad_() for t in (x, W, b))
        out = fn(xs, Ws, bs)
        assert out.dtype == dtype and out.shape == (T, B, 4, H)
        out.backward(g)
        return out.detach(), xs.grad, Ws.grad, bs.grad

    got = grads(lambda xs, Ws, bs: tlstm.input_projection(xs, Ws, bs, dtype, gate_scale=scale))
    assert seen == [dtype]
    want = grads(lambda xs, Ws, bs: _projection_by_parts(
        xs.to(dtype), Ws.to(dtype), bs, dtype, scale))
    assert seen == [dtype]
    for a, w in zip(got[:3], want[:3]):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert got[3].dtype == torch.float32
    _close(got[3].numpy(), want[3].numpy(), 1e-6)


def test_init_matches_keras_conventions():
    p = tlstm.init_bilstm_params(torch.Generator().manual_seed(0), F_IN, H)
    assert p["W"].shape == (2, F_IN, 4, H) and p["U"].shape == (2, H, 4, H)
    assert p["b"].shape == (2, 4, H)
    assert float(p["W"].abs().max()) <= 0.05
    for d in range(2):
        u = p["U"][d].reshape(H, 4 * H)
        np.testing.assert_allclose((u @ u.T).numpy(), np.eye(H), atol=1e-5)
        np.testing.assert_array_equal(p["b"][d].numpy(), np.eye(4)[1][:, None] * np.ones(H))
    shapes = jax.eval_shape(
        lambda k: jlstm.init_bilstm_params(k, F_IN, H), jax.random.key(0)
    )
    assert {k: tuple(v.shape) for k, v in shapes.items()} == {
        k: tuple(v.shape) for k, v in p.items()
    }


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(8)
    xp0, xp1 = (torch.from_numpy(rng.standard_normal((T, B, 4, H)).astype(np.float32))
                for _ in range(2))
    U = torch.from_numpy(_jax_params(9)["U"])
    before = dispatch.launch_counts()["bilstm_tm_fwd"]
    got = k1.bilstm_tm(xp0, xp1, U, store_c=True)
    want = tlstm.bilstm_scan_tm_plain(xp0, xp1, U, store_c=True)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert dispatch.launch_counts()["bilstm_tm_fwd"] == before


def test_mixed_devices_are_refused():
    xp = torch.zeros((2, 1, 4, 2))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        k1.bilstm_tm(xp, xp, torch.zeros((2, 2, 4, 2), device="meta"))


def test_train_mode_dropout_follows_the_key():
    """In train mode the dropout masks come from the key, one per
    direction, constant over time, and a train-mode layer without a key
    is refused."""
    p = _torch(_jax_params())
    x = torch.from_numpy(_x(2))
    with pytest.raises(ValueError, match="rng"):
        tlstm.bilstm_layer_tm(p, x, train=True, dropout=0.5)
    key = prng.fold_name(prng.root_key(0), "drop_0")
    a = tlstm.bilstm_layer_tm(p, x, train=True, dropout=0.5, rng=key)
    b = tlstm.bilstm_layer_tm(p, x, train=True, dropout=0.5, rng=key)
    c = tlstm.bilstm_layer_tm(p, x, train=True, dropout=0.5, rng=prng.fold_in(key, 1))
    eval_out = tlstm.bilstm_layer_tm(p, x)
    assert a.shape == (T, B, 2 * H) and torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, eval_out)
    assert torch.equal(tlstm.bilstm_layer_tm(p, x, train=True, dropout=0.0), eval_out)


def _bwd_case(seed, hidden):
    rng = np.random.default_rng(seed)
    xp0, xp1 = (rng.standard_normal((T, B, 4, hidden)).astype(np.float32) for _ in range(2))
    U = _jax_params(seed + 1, hidden=hidden)["U"]
    g0, g1 = (rng.standard_normal((T, B, hidden)).astype(np.float32) for _ in range(2))
    return xp0, xp1, U, g0, g1


def _pallas_vjp(xp0, xp1, U, g0, g1):
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, u: pk.pallas_bilstm_tm(a, b, u, interpret=True),
                     jnp.asarray(xp0, bf), jnp.asarray(xp1, bf), jnp.asarray(U))
    return [np.asarray(v.astype(jnp.float32)) for v in vjp((jnp.asarray(g0), jnp.asarray(g1)))]


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("hidden", [8, 7])
def test_bwd_plain_matches_pallas_vjp(hidden):
    xp0, xp1, U, g0, g1 = _bwd_case(11, hidden)
    want = _pallas_vjp(xp0, xp1, U, g0, g1)
    bf = torch.bfloat16
    xs = [torch.from_numpy(a).to(bf) for a in (xp0, xp1)]
    Ub = torch.from_numpy(U).to(bf)
    streams = tlstm.bilstm_scan_tm_plain(*xs, Ub, store_c=True, out_dtype=bf)
    dz0, dz1, dU = tlstm.bilstm_scan_tm_bwd_plain(
        *xs, Ub, *streams, torch.from_numpy(g0).to(bf), torch.from_numpy(g1).to(bf))
    assert dz0.dtype == bf and dz0.shape == (T, B, 4, hidden)
    _close(dz0.float().numpy(), want[0], TOL_DXP_REL)
    _close(dz1.float().numpy(), want[1], TOL_DXP_REL)
    dU = dU.to(bf).float().numpy()
    assert np.linalg.norm(dU - want[2]) <= TOL_DU_REL * np.linalg.norm(want[2])


def test_autograd_function_matches_pallas_vjp():
    xp0, xp1, U, g0, g1 = _bwd_case(12, H)
    want = _pallas_vjp(xp0, xp1, U, g0, g1)
    xs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (xp0, xp1)]
    Ut = torch.from_numpy(U).requires_grad_()
    hs0, hs1 = k1.BiLSTMTm.apply(*xs, Ut)
    assert hs0.dtype == torch.float32
    (hs0 * torch.from_numpy(g0) + hs1 * torch.from_numpy(g1)).sum().backward()
    assert xs[0].grad.dtype == torch.bfloat16 and Ut.grad.dtype == torch.float32
    _close(xs[0].grad.float().numpy(), want[0], TOL_DXP_REL)
    _close(xs[1].grad.float().numpy(), want[1], TOL_DXP_REL)
    got_u = Ut.grad.numpy()
    assert np.linalg.norm(got_u - want[2]) <= TOL_DU_REL * np.linalg.norm(want[2])
    # dU is rounded through bf16, as JAX rounds it to the kernel's bf16 U.
    assert np.array_equal(got_u, Ut.grad.to(torch.bfloat16).float().numpy())
