"""The control — the plain reference in float8 e4m3, one precision below the
configurations' bfloat16, put in the program's place — comes out not
correct against each cell's limits. On the CPU at the published widths
with short sequences and small batches; on the card (marked ``cuda``) at
each cell's own size."""

import time

import pytest
import torch

from benchmark import harness

CELLS = ["speech-train-b128", "rgb-train-b16", "speech-decode-b128", "speech-infer-b1"]
SHORT = {
    "speech-train-b128": {"params": {"batch": 8, "sequences": 24, "label_len": [2, 6]},
                          "pipeline": {"maxlen": 64}},
    "rgb-train-b16": {"params": {"batch": 2, "sequences": 6, "label_len": [2, 4]},
                      "pipeline": {"maxlen": 16}},
    "speech-decode-b128": {"params": {"batch": 8, "pool": 16, "sample_every": 1, "check_rows": 16},
                           "pipeline": {"maxlen": 64}},
    "speech-infer-b1": {"params": {"pool": 8, "sample_every": 1, "check_rows": 8},
                        "pipeline": {"maxlen": 64}},
}


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_short_lengths(cell_name):
    cell = harness.load_cell(cell_name, overrides=SHORT[cell_name])
    r = harness.run(cell, 2**31 + 5, 0.2, False, torch.device("cpu"), time.perf_counter(),
                    substitute="control")
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_full_size(cell_name, cuda_device):
    cell = harness.load_cell(cell_name)
    seconds = 7.0 if cell.kind == "infer" else 2.0
    r = harness.run(cell, 2**31 + 6, seconds, False, cuda_device, time.perf_counter(),
                    substitute="control")
    assert not r["correct"], r["checks"]
