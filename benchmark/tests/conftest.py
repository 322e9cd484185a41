"""Tiny sizes of the benchmark's cells, for the CPU (the port's plain
versions): every width and length cut, f32 compute, so that a sound run
agrees with the reference to rounding."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_PIPELINE = {"maxlen": 24, "encoder": {"hidden": 8}, "compute_dtype": "float32",
                 "max_label_len": 6}
TINY_PARAMS = {
    "speech-train-b128": {"batch": 4, "sequences": 16, "label_len": [1, 3]},
    "rgb-train-b16": {"batch": 2, "sequences": 6, "label_len": [1, 3]},
    "speech-infer-b1": {"pool": 8, "sample_every": 2, "check_rows": 4, "head_scale": 2000},
    "speech-decode-b128": {"batch": 4, "pool": 16, "sample_every": 2, "check_rows": 8,
                           "head_scale": 2000},
}
# The head's scale at hidden 8 that makes about half the frames clear the
# decode threshold, as 50 does at the published widths.


def tiny(name: str) -> dict:
    """The overrides that shrink cell ``name``."""
    pipeline = copy.deepcopy(TINY_PIPELINE)
    if name.startswith("rgb"):
        pipeline["cnn"] = {"img_dim": 44}
    return {"pipeline": pipeline, "params": dict(TINY_PARAMS[name])}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)
