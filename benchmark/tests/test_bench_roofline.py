"""roofline.py's bytes, operations and model FLOPs against hand arithmetic
at two shapes each."""

import math

import pytest

from benchmark import roofline


@pytest.mark.parametrize("T,B,H", [(1900, 128, 500), (10, 2, 3)])
def test_lstm_bound(T, B, H):
    f = roofline.lstm_bound(T, B, H, dirs=2, backward=False, store_c=True)
    ops = 2 * T * 1 * 2 * B * H * 4 * H
    nbytes = 2 * (T * B * 4 * H * 2 + H * 4 * H * 2 + 2 * T * B * H * 2)
    assert math.isclose(f["bound_ms"], 1e3 * max(ops / 989e12, nbytes / 3.35e12))
    b = roofline.lstm_bound(T, B, H, dirs=2, backward=True, store_c=True)
    ops_b = 2 * ops
    bytes_b = 2 * (2 * T * B * 4 * H * 2 + H * 4 * H * 2 + 3 * T * B * H * 2)
    assert math.isclose(b["bound_ms"], 1e3 * max(ops_b / 989e12, bytes_b / 3.35e12))


def test_lstm_bound_by_operations_and_by_bytes():
    f = roofline.lstm_bound(1900, 128, 500, dirs=2, backward=False, store_c=False)
    assert f["bound_by"] == "operations"
    assert math.isclose(f["bound_ms"], 1e3 * 2 * 1900 * 2 * 128 * 500 * 2000 / 989e12)
    small = roofline.lstm_bound(10, 2, 3, dirs=2, backward=False, store_c=False)
    assert small["bound_by"] == "bytes"
    assert math.isclose(small["bound_ms"], 1e3 * 2 * (10 * 2 * 12 * 2 + 3 * 12 * 2
                                                      + 10 * 2 * 3 * 2) / 3.35e12)


@pytest.mark.parametrize("T,B,K,N,lens", [(1898, 2, 44, 150, [16, 40]), (5, 3, 4, 2, [1, 2, 0])])
def test_ctc_bound(T, B, K, N, lens):
    visits = roofline.ctc_visits([T] * B, lens)
    assert visits == sum(T * (2 * n + 1) for n in lens)
    f = roofline.ctc_bound(T, B, K, N, visits, backward=False, store=True)
    alphas = 4 * sum(T * (2 * n + 1) for n in lens)  # the visited states, not the padded N
    nbytes = T * B * K * 4 + B * N * 4 + 2 * B * 4 + B * 4 + alphas
    assert math.isclose(f["bound_ms"], 1e3 * max(nbytes / 3.35e12, 13 * visits / 67e12))
    b = roofline.ctc_bound(T, B, K, N, visits, backward=True)
    nbytes_b = 2 * T * B * K * 4 + alphas + B * N * 4 + 2 * B * 4 + 2 * B * 4
    assert math.isclose(b["bound_ms"], 1e3 * max(nbytes_b / 3.35e12, 17 * visits / 67e12))


SPEECH = {"maxlen": 1900, "num_feats": 39, "nb_classes": 44, "cnn": None,
          "encoder": {"hidden": 500, "depth": 2}}
RGB = {"maxlen": 1900, "num_feats": 3600, "nb_classes": 22,
       "cnn": {"channels": [16, 32, 48], "kernel_sizes": [5, 5, 4], "pool_sizes": [2, 2, 2],
               "img_dim": 60}, "encoder": {"hidden": 512, "depth": 2}}


def test_model_flops_speech():
    B, T = 128, 1900
    proj0 = 2 * 2 * T * B * 39 * 2000
    proj1 = 2 * 2 * T * B * 1000 * 2000
    rec = 2 * 2 * T * B * 500 * 2000
    head = 2 * T * B * 1000 * 44
    fwd = proj0 + proj1 + 2 * rec + head
    assert math.isclose(roofline.model_flops(SPEECH, B, train=False), fwd)
    assert math.isclose(roofline.model_flops(SPEECH, B, train=True), 3 * fwd - proj0)
    assert 11.8e12 < roofline.model_flops(SPEECH, B, train=True) < 12.0e12


def test_model_flops_rgb():
    B, T = 16, 1900
    frames = B * T
    conv0 = 2 * 56 * 56 * 16 * 1 * 25
    conv = conv0 + 2 * 24 * 24 * 32 * 16 * 25 + 2 * 9 * 9 * 48 * 32 * 16
    H = 512
    fwd = frames * conv + 2 * 2 * frames * 768 * 4 * H + 2 * 2 * frames * 1024 * 4 * H \
        + 2 * (2 * 2 * frames * H * 4 * H) + 2 * frames * 1024 * 22
    assert math.isclose(roofline.model_flops(RGB, B, train=False), fwd)
    assert math.isclose(roofline.model_flops(RGB, B, train=True), 3 * fwd - frames * conv0)
