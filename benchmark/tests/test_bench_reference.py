"""The frozen plain reference against the port's plain CPU path at a tiny
size (f32 compute), and its hand-written recurrence adjoint against
autograd."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import blstm_ctc, prng as ref_prng
from conftest import tiny

SEED = 2**31 + 77


def _model_and_reference(cell_name):
    from mgr_tpu_torch.models.zoo import build_model

    cell = harness.load_cell(cell_name, overrides=tiny(cell_name))
    cfg = harness.pipeline_config(cell)
    model = build_model(cfg, device="cpu")
    w = harness.make_weights({k: tuple(v.shape) for k, v in model.named_parameters()}, SEED, "cpu")
    harness.load_weights(model, w)
    return cell, cfg, model, blstm_ctc.Reference(cell.config["pipeline"], w, "cpu")


@pytest.mark.parametrize("cell_name", ["speech-train-b128", "rgb-train-b16"])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_the_port(cell_name, train):
    from mgr_tpu_torch.core import prng

    cell, cfg, model, ref = _model_and_reference(cell_name)
    B, T = 3, cfg.maxlen
    g = torch.Generator().manual_seed(1)
    if cfg.cnn is None:
        x = torch.randn((B, T, cfg.num_feats), generator=g)
    else:
        x = (torch.randint(0, 256, (B, T, 44, 44, 1), generator=g).float() - 128.0) / 255.0
    key = prng.fold_in(prng.fold_name(prng.root_key(SEED), "dropout"), 4)
    with torch.no_grad():
        port = model.apply_tm(x, train=train, rng=key if train else None)
        mine = ref.logits(x, ref_prng.Key(SEED, ("dropout", 4)) if train else None)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)


def test_ctc_matches_the_port():
    from mgr_tpu_torch.ops.ctc import ctc_loss_from_logits

    g = torch.Generator().manual_seed(2)
    T, B, C, N = 30, 4, 6, 7
    logits = torch.randn((T, B, C), generator=g)
    labels = torch.tensor([[1, 1, 2, -1, -1, -1, -1], [3, 4, 3, 4, 2, 1, 1],
                           [2, -1, -1, -1, -1, -1, -1], [1, 2, 2, 2, 3, -1, -1]])
    lab_len = torch.tensor([3, 7, 1, 5])
    in_len = torch.tensor([28, 28, 15, 20])
    port = ctc_loss_from_logits(logits, labels, in_len, lab_len, trim_frames=2, time_major=True)
    mine = blstm_ctc.ctc_nll(logits, labels, in_len, lab_len, 2)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-4)


def test_recurrence_adjoint_matches_autograd():
    g = torch.Generator().manual_seed(3)
    D, T, B, H = 2, 7, 3, 4
    xs = torch.randn((D, T, B, 4 * H), generator=g, dtype=torch.float64, requires_grad=True)
    U = (0.5 * torch.randn((D, H, 4 * H), generator=g, dtype=torch.float64)).requires_grad_()
    w = torch.randn((D, T, B, H), generator=g, dtype=torch.float64)

    def plain(xs, U):
        h = xs.new_zeros((D, B, H))
        c = xs.new_zeros((D, B, H))
        out = []
        for s in range(T):
            z = xs[:, s] + torch.bmm(h, U)
            sg = torch.clamp(0.2 * z + 0.5, 0, 1)
            c = sg[..., H:2 * H] * c + sg[..., :H] * torch.tanh(z[..., 2 * H:3 * H])
            h = sg[..., 3 * H:] * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)

    a = torch.autograd.grad((plain(xs, U) * w).sum(), (xs, U))
    b = torch.autograd.grad((blstm_ctc._Recurrence.apply(xs, U, None) * w).sum(), (xs, U))
    for x, y in zip(a, b):
        torch.testing.assert_close(y, x, rtol=1e-10, atol=1e-12)


def test_training_steps_match_the_port():
    """Three steps of the tiny speech cell through the harness: the port's
    losses, first gradient and change against the reference's."""
    import time

    cell = harness.load_cell("speech-train-b128", overrides=tiny("speech-train-b128"))
    r = harness.run(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"]
    for name, c in r["checks"].items():
        assert c["value"] < 1e-4, name


def test_fp8_precision_rounds():
    x = torch.tensor([0.1, 1.0 / 3.0, 2.0])
    y = blstm_ctc.PRECISIONS["fp8"](x)
    assert y[2] == 2.0 and not torch.equal(x, y)
    assert np.abs((y - x).numpy() / x.numpy()).max() < 2 ** -3
