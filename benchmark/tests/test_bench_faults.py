"""A run with the timed path broken underneath comes out not correct, once
for each fault its cell can have; a sound run comes out correct. The
harness's look for a card is skipped: the cells run at a tiny size on the
CPU, against each cell's own limits."""

import contextlib
import time

import pytest
import torch

from benchmark import faults, harness
from conftest import tiny

CASES = [("speech-train-b128", f) for f in faults.FAULTS["train"]]
CASES += [("rgb-train-b16", "half_batch")]
CASES += [("speech-decode-b128", f) for f in faults.FAULTS["decode"]]
CASES += [("speech-infer-b1", f) for f in faults.FAULTS["infer"]]


def _run(cell_name, fault=None, seed=424242):
    cell = harness.load_cell(cell_name, overrides=tiny(cell_name))
    with faults.planted(fault) if fault else contextlib.nullcontext():
        return harness.run(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_a_fault_is_not_correct(cell_name, fault):
    r = _run(cell_name, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell_name", ["speech-train-b128", "rgb-train-b16",
                                       "speech-decode-b128", "speech-infer-b1"])
def test_a_sound_run_is_correct(cell_name):
    r = _run(cell_name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    if "class_gap" in r["checks"]:  # the compared rows emit tokens
        assert r["summary"]["uncompared"]["emitted"] > 20


def test_faults_are_removed_after_the_block():
    from mgr_tpu_torch.decode import decoder
    from mgr_tpu_torch.train import step

    before = (step._apply_updates, step._loss_and_grads, decoder.make_decode_step,
              decoder.emitted_sequences, decoder.DECODE_SPECS)
    for f in sorted({f for names in faults.FAULTS.values() for f in names}):
        with faults.planted(f):
            pass
    assert before == (step._apply_updates, step._loss_and_grads, decoder.make_decode_step,
                      decoder.emitted_sequences, decoder.DECODE_SPECS)
