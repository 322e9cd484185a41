"""Each traffic kind makes the same inputs and weights from the same seed,
other ones from another seed, and takes seeds past 32 bits."""

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import tiny

SEED = 2**33 + 12345


def _inputs(cell_name, seed):
    cell = harness.load_cell(cell_name, overrides=tiny(cell_name))
    drv = harness.load_module("traffic", cell.kind).Driver(
        harness.Run(cell, seed, torch.device("cpu")))
    drv.setup()
    if cell.kind == "train":
        if drv.indexed:
            data = {k: v.numpy() for k, v in drv.arrays.items()}
            data["rows"] = drv._rows(0)
        else:
            data = {f"{i}.{k}": v for i, b in enumerate(drv.batches) for k, v in b.items()}
    else:
        data = {"pool": drv.pool, "order": drv.order}
    data.update({f"w.{k}": v.numpy() for k, v in drv.p0.items()})
    return data


@pytest.mark.parametrize("cell", ["speech-train-b128", "rgb-train-b16", "speech-infer-b1",
                                  "speech-decode-b128"])
def test_same_seed_same_inputs(cell):
    a, b, c = _inputs(cell, SEED), _inputs(cell, SEED), _inputs(cell, SEED + 1)
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    differ = [k for k in a if not np.array_equal(a[k], c[k])]
    assert any(k.startswith("w.") for k in differ)
    assert any(not k.startswith("w.") for k in differ)


def test_labels_keep_their_ranges():
    data = _inputs("speech-train-b128", SEED)
    lab, n = data["labels"], data["label_length"]
    assert n.min() >= 1 and n.max() <= 3
    for row, length in zip(lab, n):
        assert (row[:length] >= 1).all() and (row[:length] <= 42).all()
        assert (row[length:] == -1).all()


def test_weights_follow_the_reference_init():
    shapes = {"encoder.blstm_0.W": (2, 5, 4, 6), "encoder.blstm_0.U": (2, 6, 4, 6),
              "encoder.blstm_0.b": (2, 4, 6), "head.W": (12, 3), "head.b": (3,)}
    w = harness.make_weights(shapes, SEED, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    assert w["head.W"].abs().max() <= 0.05 and w["encoder.blstm_0.W"].abs().max() <= 0.05
    for d in range(2):
        u = w["encoder.blstm_0.U"][d].reshape(6, 24)
        torch.testing.assert_close(u @ u.T, torch.eye(6), atol=1e-5, rtol=0)
    assert (w["encoder.blstm_0.b"][:, 1] == 1).all() and (w["head.b"] == 0).all()
