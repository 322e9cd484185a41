"""The port's batch-major layer API (``mgr_tpu_torch.ops.lstm.bilstm_layer``,
``lstm_layer``, the recurrence behind them with kernel K6a/K6b's plain
versions, and ``kernels.lstm_scan.LSTMScan``) held against the JAX
package on the same parameters and inputs. The JAX Pallas path runs as
tests/test_pallas.py runs it on the CPU: the backend forced to "pallas",
in interpret mode.

Sizes: T = 7, 11 and 13 (not multiples of the TPU kernel's time chunk of
4), B = 3, H = 8 and 7 (odd: the port pads one dead unit), F = 5.

Tolerances:
  * f32 plain recurrence and layers vs JAX's XLA path: 1e-5 absolute
    (f32 sums in another order); f32 gradients 1e-5 of the largest
    entry.
  * bf16 recurrence and layers vs Pallas interpret: 3e-2 absolute (bf16
    h stream; one bf16 ulp of h is ~4e-3); bf16 layer gradients 5e-2 of
    the largest entry, as tests/test_pallas.py.
  * bf16 adjoint (K6b's plain version, and LSTMScan) vs ``jax.vjp`` of
    ``pallas_recurrent_scan``: dxp within 1e-2 of the largest |dxp|, dU
    within 1e-3 relative Frobenius, as tests/test_torch_lstm.py holds
    K2's: the same values rounded to bf16 at the same places, f32 sums in
    another order.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgr_tpu.core import prng as jprng
from mgr_tpu.core.config import EncoderConfig as JEncoderConfig
from mgr_tpu.models import encoder as jencoder
from mgr_tpu.ops import dispatch as jdispatch
from mgr_tpu.ops import lstm as jlstm
from mgr_tpu.ops import pallas_kernels as pk
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.config import EncoderConfig
from mgr_tpu_torch.kernels import lstm_scan as k6
from mgr_tpu_torch.models.encoder import Encoder
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm
from torch_jax_draws import jax_key, replay_jax_draws

torch.set_num_threads(1)

T, B, F_IN, H = 11, 3, 5, 8
TOL_F32 = 1e-5
TOL_BF16 = 3e-2
TOL_GRAD_BF16 = 5e-2
TOL_DXP_REL = 1e-2
TOL_DU_REL = 1e-3
BF = torch.bfloat16


@contextlib.contextmanager
def jax_backend(mode):
    """The JAX recurrence backend: "pallas" (interpret mode on the CPU) or
    "xla", restored afterwards."""
    before = jdispatch.MODE
    jdispatch.set_mode(mode)
    try:
        yield
    finally:
        jdispatch.set_mode(before)


@pytest.fixture
def jax_streams(monkeypatch):
    """Route the port's draws through jax.random on the same paths;
    returns the list of (kind, path, shape) drawn."""
    return replay_jax_draws(monkeypatch, with_shape=True)


def _bi_params(seed=0, in_dim=F_IN, hidden=H):
    p = jlstm.init_bilstm_params(jax.random.key(seed), in_dim, hidden)
    return {k: np.array(v) for k, v in p.items()}


def _one_params(seed=0, in_dim=F_IN, hidden=H):
    p = jlstm.init_lstm_params(jax.random.key(seed), in_dim, hidden)
    return {k: np.array(v) for k, v in p.items()}


def _t(p, **kw):
    return {k: torch.from_numpy(v.copy()).requires_grad_(kw.get("grad", False))
            for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(seed=1, shape=(B, T, F_IN)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bf16(a):
    """a rounded to bf16, as f32 numpy (an input both frameworks hold exactly)."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _scan_case(seed, D, hidden, steps=T):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((D, B, steps, 4, hidden)).astype(np.float32)
    U = (0.5 * rng.standard_normal((D, hidden, 4, hidden))).astype(np.float32)
    g = rng.standard_normal((D, B, steps, hidden)).astype(np.float32)
    return xp, U, g


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rel * scale


# (a) the plain recurrence in f32 against JAX's XLA scan.
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("steps", [7, 13])
def test_scan_plain_f32_matches_xla(D, steps):
    xp, U, _ = _scan_case(D + steps, D, H, steps)
    with jax_backend("xla"):
        want = jlstm._recurrent_scan(jnp.asarray(xp), jnp.asarray(U), jnp.float32, unroll=1)
    (got,) = tlstm.recurrent_scan_plain(torch.from_numpy(xp), torch.from_numpy(U))
    assert got.shape == (D, B, steps, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)


# (b) the plain recurrence in bf16 against the Pallas kernel (interpret).
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("hidden", [8, 7])
def test_scan_plain_bf16_matches_pallas_interpret(D, hidden):
    xp, U, _ = _scan_case(20 + hidden, D, hidden, 13)
    want = pk.pallas_recurrent_scan(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(U),
                                    interpret=True)
    got = k6.lstm_scan_streams(torch.from_numpy(xp).to(BF), torch.from_numpy(U).to(BF))[0]
    assert got.shape == (D, B, 13, hidden) and got.dtype == BF
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL_BF16, rtol=0)


def _pallas_vjp(xp, U, g):
    _, vjp = jax.vjp(lambda a, u: pk.pallas_recurrent_scan(a, u, interpret=True),
                     jnp.asarray(xp, jnp.bfloat16), jnp.asarray(U))
    return [np.asarray(v.astype(jnp.float32)) for v in vjp(jnp.asarray(g, jnp.bfloat16))]


# (c) the adjoint: K6b's plain version + the dU GEMM, and LSTMScan.
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("hidden", [8, 7])
def test_scan_bwd_plain_matches_pallas_vjp(D, hidden):
    xp, U, g = _scan_case(30 + hidden, D, hidden)
    g = _bf16(g)
    want = _pallas_vjp(xp, U, g)
    xs, Ub = torch.from_numpy(xp).to(BF), torch.from_numpy(U).to(BF)
    hs, cs = tlstm.recurrent_scan_plain(xs, Ub, store_c=True, out_dtype=BF)
    dz = tlstm.recurrent_scan_bwd_plain(xs, Ub, hs, cs, torch.from_numpy(g).to(BF))
    assert dz.shape == (D, B, T, 4, hidden) and dz.dtype == BF
    _close(dz.float().numpy(), want[0], TOL_DXP_REL)
    dU = tlstm.scan_weight_grad(hs, dz)
    assert dU.shape == (D, hidden, 4, hidden) and dU.dtype == torch.float32
    dU = dU.to(BF).float().numpy()
    assert np.linalg.norm(dU - want[1]) <= TOL_DU_REL * np.linalg.norm(want[1])


@pytest.mark.parametrize("D", [1, 2])
def test_autograd_function_matches_pallas_vjp(D):
    xp, U, g = _scan_case(40 + D, D, H)
    g = _bf16(g)
    want = _pallas_vjp(xp, U, g)
    x = torch.from_numpy(xp).to(BF).requires_grad_()
    u = torch.from_numpy(U).requires_grad_()
    hs = k6.LSTMScan.apply(x, u)
    assert hs.dtype == BF and hs.shape == (D, B, T, H)
    (hs.float() * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == BF and u.grad.dtype == torch.float32
    _close(x.grad.float().numpy(), want[0], TOL_DXP_REL)
    got_u = u.grad.numpy()
    assert np.linalg.norm(got_u - want[1]) <= TOL_DU_REL * np.linalg.norm(want[1])
    # dU is rounded through bf16, as JAX rounds it to the kernel's bf16 U.
    assert np.array_equal(got_u, u.grad.to(BF).float().numpy())


def test_cpu_tensors_take_the_plain_versions():
    xp, U, g = (torch.from_numpy(a) for a in _scan_case(50, 2, H))
    before = dispatch.launch_counts()
    hs, cs = k6.lstm_scan_streams(xp, U, store_c=True)
    want = tlstm.recurrent_scan_plain(xp, U, store_c=True)
    assert torch.equal(hs, want[0]) and torch.equal(cs, want[1])
    assert torch.equal(k6.lstm_scan_bwd(xp, U, hs, cs, g),
                       tlstm.recurrent_scan_bwd_plain(xp, U, hs, cs, g))
    assert dispatch.launch_counts() == before
    with pytest.raises(ValueError, match="D in"):
        k6.lstm_scan_streams(torch.cat([xp, xp[:1]]), torch.cat([U, U[:1]]))
    with pytest.raises(ValueError, match="want streams"):
        k6.lstm_scan_bwd(xp, U, hs, cs, g[:, :, 1:])


# (d) the layers, f32 against XLA and bf16 against Pallas interpret.
@pytest.mark.parametrize("seed", [0, 1])
def test_bilstm_layer_f32_matches_xla(seed):
    p, x = _bi_params(seed), _x(seed + 10)
    with jax_backend("xla"):
        want = jlstm.bilstm_layer(_j(p), jnp.asarray(x), compute_dtype=jnp.float32)
    got = tlstm.bilstm_layer(_t(p), torch.from_numpy(x), compute_dtype=torch.float32)
    assert got.shape == (B, T, 2 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)


@pytest.mark.parametrize("hidden", [8, 7])
def test_bilstm_layer_bf16_matches_pallas_interpret(hidden):
    p, x = _bi_params(3, hidden=hidden), _x(4)
    with jax_backend("pallas"):
        want = jlstm.bilstm_layer(_j(p), jnp.asarray(x))
    got = tlstm.bilstm_layer(_t(p), torch.from_numpy(x))
    assert got.shape == (B, T, 2 * hidden) and got.dtype == BF
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL_BF16, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(reverse):
    p, x = _one_params(5), _x(6)
    with jax_backend("xla"):
        want32 = jlstm.lstm_layer(_j(p), jnp.asarray(x), reverse=reverse,
                                  compute_dtype=jnp.float32)
    with jax_backend("pallas"):
        want16 = jlstm.lstm_layer(_j(p), jnp.asarray(x), reverse=reverse)
    got32 = tlstm.lstm_layer(_t(p), torch.from_numpy(x), reverse=reverse,
                             compute_dtype=torch.float32)
    got16 = tlstm.lstm_layer(_t(p), torch.from_numpy(x), reverse=reverse)
    assert got32.shape == (B, T, H) and got16.dtype == BF
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), atol=TOL_F32, rtol=0)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)),
                               atol=TOL_BF16, rtol=0)
    # reverse=True is the forward layer on the flipped input, flipped back.
    fwd = tlstm.lstm_layer(_t(p), torch.from_numpy(x[:, ::-1].copy()),
                           compute_dtype=torch.float32)
    if reverse:
        assert torch.equal(got32, torch.flip(fwd, dims=(1,)))


# (e) train mode: one mask drawn straight from the key.
@pytest.mark.parametrize("per_gate", [False, True])
def test_bilstm_layer_train_matches_jax(per_gate, jax_streams):
    p, x = _bi_params(7), _x(8)
    key = prng.fold_name(prng.root_key(3), "drop_0")
    with jax_backend("xla"):
        want = jlstm.bilstm_layer(_j(p), jnp.asarray(x), rng=jax_key(key), dropout=0.4,
                                  per_gate=per_gate, train=True, compute_dtype=jnp.float32)
    got = tlstm.bilstm_layer(_t(p), torch.from_numpy(x), rng=key, dropout=0.4,
                             per_gate=per_gate, train=True, compute_dtype=torch.float32)
    shape = (4, 2, B, 1, F_IN) if per_gate else (2, B, 1, F_IN)
    assert jax_streams == [("bernoulli", key.path, shape)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)
    eval_out = tlstm.bilstm_layer(_t(p), torch.from_numpy(x), compute_dtype=torch.float32)
    assert not torch.equal(got, eval_out)


def test_train_masks_differ_from_the_time_major_layers(jax_streams):
    """The batch-major layer draws one (D, B, 1, F) mask from the key; the
    time-major layer draws one (B, F) mask per direction from fold_in(key,
    d). Same parameters and key: equal in eval mode, not in train mode."""
    p, x = _t(_bi_params(9)), torch.from_numpy(_x(9))
    key = prng.fold_name(prng.root_key(0), "drop_1")
    kw = dict(compute_dtype=torch.float32)
    bm = tlstm.bilstm_layer(p, x, rng=key, dropout=0.5, train=True, **kw)
    tm = tlstm.bilstm_layer_tm(p, x.transpose(0, 1), rng=key, dropout=0.5, train=True,
                               **kw).transpose(0, 1)
    assert [c[1:] for c in jax_streams] == [
        (key.path, (2, B, 1, F_IN)), (key.path + (0,), (B, F_IN)), (key.path + (1,), (B, F_IN))]
    assert float((bm - tm).abs().max()) > 1e-2
    np.testing.assert_allclose(
        tlstm.bilstm_layer(p, x, **kw).numpy(),
        tlstm.bilstm_layer_tm(p, x.transpose(0, 1), **kw).transpose(0, 1).numpy(),
        atol=TOL_F32, rtol=0)
    with pytest.raises(ValueError, match="rng"):
        tlstm.bilstm_layer(p, x, train=True, dropout=0.5)


# (f) parameter and input gradients against jax.grad.
def _layer_grads_jax(p, x, tangent, dtype):
    def loss(params, xx):
        out = jlstm.bilstm_layer(params, xx, compute_dtype=dtype)
        return jnp.sum(out.astype(jnp.float32) * tangent)

    gp, gx = jax.grad(loss, argnums=(0, 1))(_j(p), jnp.asarray(x))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


def _layer_grads_torch(p, x, tangent, dtype):
    params = _t(p, grad=True)
    xx = torch.from_numpy(x).requires_grad_()
    out = tlstm.bilstm_layer(params, xx, compute_dtype=dtype)
    (out.float() * torch.from_numpy(tangent)).sum().backward()
    return {**{k: v.grad.numpy() for k, v in params.items()}, "x": xx.grad.numpy()}


def test_bilstm_layer_gradients_match_jax():
    p, x = _bi_params(11), _x(12)
    tangent = np.random.default_rng(13).standard_normal((B, T, 2 * H)).astype(np.float32)
    with jax_backend("xla"):
        want32 = _layer_grads_jax(p, x, tangent, jnp.float32)
    with jax_backend("pallas"):
        want16 = _layer_grads_jax(p, x, tangent, jnp.bfloat16)
    got32 = _layer_grads_torch(p, x, tangent, torch.float32)
    got16 = _layer_grads_torch(p, x, tangent, BF)
    for k in ("W", "U", "b", "x"):
        _close(got32[k], want32[k], TOL_F32)
        _close(got16[k], want16[k], TOL_GRAD_BF16)


# (g) remat: the same function, chunk by chunk.
def test_remat_matches_no_remat_and_jax():
    p, x = _bi_params(14), _x(15)
    tangent = np.random.default_rng(16).standard_normal((B, T, 2 * H)).astype(np.float32)
    outs = {}
    for remat in (False, True):
        params = _t(p, grad=True)
        xx = torch.from_numpy(x).requires_grad_()
        out = tlstm.bilstm_layer(params, xx, compute_dtype=torch.float32, remat=remat)
        (out * torch.from_numpy(tangent)).sum().backward()
        outs[remat] = [out.detach().numpy(), xx.grad.numpy()] + [
            params[k].grad.numpy() for k in ("W", "U", "b")]
    for a, b in zip(outs[False], outs[True]):
        _close(a, b, TOL_F32)
    with jax_backend("xla"):
        want = jlstm.bilstm_layer(_j(p), jnp.asarray(x), compute_dtype=jnp.float32,
                                  remat=True)
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    np.testing.assert_allclose(outs[True][0], np.asarray(want), atol=TOL_F32, rtol=0)

    # Several chunks, the last one short (T=11, chunk 4), against JAX's.
    xp, U, g = _scan_case(17, 2, H)
    xt = torch.from_numpy(xp).requires_grad_()
    ut = torch.from_numpy(U).requires_grad_()
    hs = tlstm.recurrent_scan_remat(xt, ut, torch.float32, chunk=4)
    (hs * torch.from_numpy(g)).sum().backward()

    def jloss(a, u):
        return jnp.sum(jlstm._recurrent_scan_remat(a, u, jnp.float32, chunk=4) * g)

    jhs = jlstm._recurrent_scan_remat(jnp.asarray(xp), jnp.asarray(U), jnp.float32, chunk=4)
    jdx, jdu = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(U))
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs), atol=TOL_F32, rtol=0)
    _close(xt.grad.numpy(), np.asarray(jdx), TOL_F32)
    _close(ut.grad.numpy(), np.asarray(jdu), TOL_F32)


# (h) the batch-major encoder and noise_override.
def _encoders(seed=0):
    jcfg = JEncoderConfig(hidden=H, depth=2, input_noise=0.5, dropout=(0.4, 0.5))
    jparams = jencoder.init_encoder(jprng.root_key(seed), F_IN, jcfg)
    enc = Encoder(F_IN, EncoderConfig(hidden=H, depth=2, input_noise=0.5, dropout=(0.4, 0.5)),
                  torch.Generator().manual_seed(seed))
    bridge.load_params(enc, jax.tree.map(np.array, jparams))
    return jcfg, jparams, enc


@pytest.mark.parametrize("noise_override", [None, 0.0, 0.25])
def test_encoder_apply_matches_jax(noise_override, jax_streams):
    jcfg, jparams, enc = _encoders(1)
    x = _x(18)
    key = prng.fold_name(prng.root_key(4), "encoder")
    kw = dict(compute_dtype=jnp.float32, noise_override=noise_override)
    with jax_backend("xla"):
        want_eval = jencoder.apply_encoder(jparams, jnp.asarray(x), jcfg, **kw)
        want = jencoder.apply_encoder(jparams, jnp.asarray(x), jcfg, train=True,
                                      rng=jax_key(key), **kw)
    tkw = dict(compute_dtype=torch.float32, noise_override=noise_override)
    with torch.no_grad():
        got_eval = enc.apply(torch.from_numpy(x), **tkw)
        got = enc.apply(torch.from_numpy(x), train=True, rng=key, **tkw)
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=TOL_F32, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)
    noise_drawn = any(c[0] == "normal" for c in jax_streams)
    assert noise_drawn == (noise_override != 0.0)
    with torch.no_grad():
        tm = enc.apply_tm(torch.from_numpy(x).transpose(0, 1), **tkw).transpose(0, 1)
    assert torch.equal(got_eval, tm)
