"""The tiling rule of K1 and K2 (``kernels/bilstm_tm.py::batch_groups``)
and its counter, on the CPU: two batch groups at the speech cells' shape and
at every width of the late-fusion decode, one at rgb's and at B=1, the
one-group tiling at every batch up to 32 rows (the per-step floor paths:
B=1, rgb's 16, the preset's 32), and a grid that fits one block an SM of an
H100 (132 SMs) at every batch up to 256 rows and every width the kernels
take (even H up to 512; the wrapper pads an odd H)."""

import pytest

from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.ops import dispatch

H100_SMS = 132


@pytest.mark.parametrize("B,H,groups", [
    (128, 500, 2),  # speech-train-b128, speech-decode-b128
    (16, 512, 1),   # rgb-train-b16
    (32, 500, 1), (33, 500, 2), (256, 512, 2), (128, 100, 2), (1, 500, 1),
    (64, 500, 2), (64, 300, 2), (64, 100, 2),  # late_fusion-decode-b64's five K1 launches
])
def test_groups_at_the_cells_shapes(B, H, groups):
    assert k1.batch_groups(B, H, H100_SMS) == groups


def test_one_group_up_to_32_rows():
    """K1 and K2 alike: speech-infer-b1, rgb's B=16, the preset's train
    batch of 32 and the mesh ranks' 4-16 rows (one direction, K5, or two)."""
    assert k1.GROUPED_MIN_B == 33
    for B in range(1, 33):
        for H in range(2, 513, 2):
            for dirs in (1, 2):
                assert k1.batch_groups(B, H, H100_SMS, dirs) == 1, (B, H, dirs)


def test_the_grid_fits_one_block_an_sm():
    for dirs in (1, 2):
        for H in range(2, 513, 2):
            for B in range(1, 257):
                g = k1.batch_groups(B, H, H100_SMS, dirs)
                assert k1.grid_blocks(H, g, dirs) <= H100_SMS, (B, H, dirs, g)


def test_grid_blocks():
    assert k1.grid_blocks(500, 1) == 126 and k1.grid_blocks(500, 2) == 128
    assert k1.grid_blocks(512, 1) == 128 and k1.grid_blocks(512, 2) == 128
    assert k1.grid_blocks(100, 2, dirs=1) == 14


def test_one_group_where_two_would_not_fit():
    """A card of 114 SMs (the H100 PCIe): two groups at H=500 would need
    128 co-resident blocks; one direction (K5b) or a narrower H fits."""
    assert k1.batch_groups(128, 500, 114) == 1
    assert k1.batch_groups(128, 500, 114, dirs=1) == 2
    assert k1.batch_groups(128, 300, 114) == 2


def test_k1_grid_at_every_width_the_cells_run():
    """K1's grids of two groups: 128 blocks at the speech and rgb widths,
    one an SM of the 132; the towers' and fusion layer's narrower ones; one
    direction (K5a) half of them."""
    assert k1.grid_blocks(500, 2) == k1.grid_blocks(512, 2) == 128
    assert k1.grid_blocks(300, 2) == 76 and k1.grid_blocks(100, 2) == 28
    assert k1.grid_blocks(500, 2, dirs=1) == 64 and k1.grid_blocks(512, 1, dirs=1) == 64


def test_k1_falls_back_where_two_groups_would_not_fit():
    """On 114 SMs the speech tower's K1 at H=500 keeps one group (128
    blocks would not be co-resident), while the skeletal tower's H=300 and
    the fusion layer's H=100 take two."""
    assert k1.batch_groups(64, 500, 114) == 1
    assert k1.batch_groups(64, 300, 114) == 2 and k1.batch_groups(64, 100, 114) == 2


def test_grouped_counter_is_apart_from_the_launch_counts():
    dispatch.reset_launch_counts()
    dispatch.count_launch("bilstm_tm_bwd", grouped=True)
    dispatch.count_launch("lstm_tm_bwd")
    dispatch.count_launch("bilstm_tm_fwd", grouped=True)
    dispatch.count_launch("bilstm_tm_fwd", grouped=True)
    dispatch.count_launch("lstm_scan_fwd")
    assert dispatch.grouped_counts() == {"bilstm_tm_fwd": 2, "lstm_tm_fwd": 0,
                                         "lstm_scan_fwd": 0, "bilstm_tm_bwd": 1,
                                         "lstm_tm_bwd": 0, "lstm_scan_bwd": 0}
    counts = dispatch.launch_counts()
    assert sorted(counts) == sorted(dispatch.KERNELS)
    assert counts["bilstm_tm_bwd"] == counts["lstm_tm_bwd"] == counts["lstm_scan_fwd"] == 1
    assert counts["bilstm_tm_fwd"] == 2
    dispatch.reset_launch_counts()
    assert set(dispatch.grouped_counts().values()) == {0}
    assert set(dispatch.launch_counts().values()) == {0}
