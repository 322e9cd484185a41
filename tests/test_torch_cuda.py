"""The port's CUDA kernels on a CUDA device, against their plain versions.

Every test here needs a GPU: without one it skips (a CUDA kernel has no
interpret mode). The file imports no JAX and nothing of ``mgr_tpu``, so
on a GPU host it runs with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: K1 h and c streams 3e-2 absolute (bf16 streams, f32 sums in
another order); K3 loss 1e-4 relative to max(1, |loss|) (f32 logaddexp
chains); whole-model logits on the card vs the CPU 3e-2 (bf16 model).
"""

import numpy as np
import pytest
import torch

from mgr_tpu_torch.core.config import EncoderConfig, get_preset
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.kernels import ctc as k3
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.ops import ctc as tctc
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.train.step import make_eval_step

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL_K1 = 3e-2
TOL_K3_REL = 1e-4
TOL_LOGITS = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("T,B,H", [(24, 3, 8), (40, 130, 300), (16, 1, 7), (12, 520, 16)])
def test_k1_matches_plain_version(cuda, T, B, H):
    rng = np.random.default_rng(H)
    bf = torch.bfloat16
    xp = torch.from_numpy(rng.standard_normal((2, T, B, 4, H)).astype(np.float32)).to(cuda, bf)
    U = tlstm.init_bilstm_params(torch.Generator().manual_seed(H), 4, H)["U"].to(cuda, bf)
    before = dispatch.launch_counts()["bilstm_tm_fwd"]
    got = k1.bilstm_tm(xp[0], xp[1], U, store_c=True)
    assert dispatch.launch_counts()["bilstm_tm_fwd"] == before + 1
    want = tlstm.bilstm_scan_tm_plain(xp[0], xp[1], U, store_c=True)
    for g, w in zip(got, want):
        assert g.shape == (T, B, H)
        assert float((g - w).abs().max()) <= TOL_K1


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


@pytest.mark.parametrize("B,T,K,N", [(4, 24, 6, 4), (7, 400, 44, 150)])
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


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(tlstm, "bilstm_scan_tm_plain", refuse)
    monkeypatch.setattr(tctc, "ctc_alpha_loss_plain", refuse)
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


def test_model_on_the_card_matches_the_cpu(cuda):
    cfg = get_preset("speech").replace(maxlen=48, encoder=EncoderConfig(hidden=32))
    cpu_model = build_model(cfg, seed=3)
    card_model = build_model(cfg, seed=3, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 48, cfg.num_feats)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_model(x)
        got = card_model(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= TOL_LOGITS
