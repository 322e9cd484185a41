"""K2's tiling rule (``kernels/bilstm_tm.py::bwd_groups``) and its counter,
on the CPU: two batch groups at the speech train cell's shape and one at
rgb's, the one-group tiling at every batch up to 32 rows (the per-step
floor paths: B=1, rgb's 16, the preset's 32), and a grid that fits one
block an SM of an H100 (132 SMs) at every batch up to 256 rows and every
width the kernel takes (even H up to 512; the wrapper pads an odd H)."""

import pytest

from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.ops import dispatch

H100_SMS = 132


@pytest.mark.parametrize("B,H,groups", [
    (128, 500, 2),  # speech-train-b128
    (16, 512, 1),   # rgb-train-b16
    (32, 500, 1), (33, 500, 2), (256, 512, 2), (128, 100, 2), (1, 500, 1),
])
def test_groups_at_the_cells_shapes(B, H, groups):
    assert k1.bwd_groups(B, H, H100_SMS) == groups


def test_one_group_up_to_32_rows():
    assert k1.GROUPED_MIN_B == 33
    for B in range(1, 33):
        for H in range(2, 513, 2):
            for dirs in (1, 2):
                assert k1.bwd_groups(B, H, H100_SMS, dirs) == 1, (B, H, dirs)


def test_the_grid_fits_one_block_an_sm():
    for dirs in (1, 2):
        for H in range(2, 513, 2):
            for B in range(1, 257):
                g = k1.bwd_groups(B, H, H100_SMS, dirs)
                assert k1.bwd_grid(H, g, dirs) <= H100_SMS, (B, H, dirs, g)


def test_grid_blocks():
    assert k1.bwd_grid(500, 1) == 126 and k1.bwd_grid(500, 2) == 128
    assert k1.bwd_grid(512, 1) == 128 and k1.bwd_grid(512, 2) == 128
    assert k1.bwd_grid(100, 2, dirs=1) == 14


def test_one_group_where_two_would_not_fit():
    """A card of 114 SMs (the H100 PCIe): two groups at H=500 would need
    128 co-resident blocks; one direction (K5b) or a narrower H fits."""
    assert k1.bwd_groups(128, 500, 114) == 1
    assert k1.bwd_groups(128, 500, 114, dirs=1) == 2
    assert k1.bwd_groups(128, 300, 114) == 2


def test_grouped_counter_is_apart_from_the_launch_counts():
    dispatch.reset_launch_counts()
    dispatch.count_launch("bilstm_tm_bwd", grouped=True)
    dispatch.count_launch("lstm_tm_bwd")
    assert dispatch.grouped_counts() == {"bilstm_tm_bwd": 1, "lstm_tm_bwd": 0,
                                         "lstm_scan_bwd": 0}
    counts = dispatch.launch_counts()
    assert sorted(counts) == sorted(dispatch.KERNELS)
    assert counts["bilstm_tm_bwd"] == counts["lstm_tm_bwd"] == 1
    dispatch.reset_launch_counts()
    assert set(dispatch.grouped_counts().values()) == {0}
    assert set(dispatch.launch_counts().values()) == {0}
