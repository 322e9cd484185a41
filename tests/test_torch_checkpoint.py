"""A train-state slot is written and read as one whole.

A save of ``fit`` renames three files into place: the slot's
``state.pt`` (parameters, step and Adam state together), its
``params.pt`` (what decode reads) and the fitmeta sidecar. A save killed
before any one of those renames must leave a slot that resumes wholly
from one save, the step, the Adam moments and the parameters all from
the same one, and ``fit(resume=True)`` must then start at the epoch those
parameters finished. The port alone, no JAX: a tiny skeletal model in
f32 with dropout and noise off, on the CPU, where every step is
deterministic, so a state is compared bit for bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mgr_tpu_torch.core import checkpoint as ckpt
from mgr_tpu_torch.core.config import EncoderConfig, get_preset
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.train import loop
from mgr_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)

STAMP = "skeletal"
SAVE_RENAMES = ("skeletal_latest.state.pt", "skeletal_latest.params.pt",
                "skeletal_fitmeta.json")


def _cfg():
    enc = EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                        output_dropout=0.0)
    return get_preset("skeletal").replace(maxlen=24, batch_size=2, max_label_len=4,
                                          encoder=enc, compute_dtype="float32", patience=50)


def _data(cfg):
    rng = np.random.default_rng(0)
    n = 8
    feats = rng.standard_normal((n, cfg.maxlen, cfg.num_feats)).astype(np.float32)
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=n).astype(np.int32)
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    in_len = np.full((n,), cfg.maxlen - cfg.ctc.trim_frames, np.int32)
    ids = list(range(n))
    return Batcher(feats, labels, lab_len, in_len, ids, train_ids=ids[:6], val_ids=ids[6:])


def _replace_killed_at(n, monkeypatch):
    """Patch os.replace: from the first rename of the latest slot's
    state.pt on, record each rename and raise instead of the n-th."""
    real = os.replace
    seen = []

    def replace(src, dst):
        if seen or str(dst).endswith(SAVE_RENAMES[0]):
            seen.append(os.path.basename(str(dst)))
            if len(seen) == n:
                raise OSError(f"killed before renaming {dst}")
        return real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    return seen


def _slot(workdir, cfg):
    return ckpt.load_train_state(workdir, STAMP, create_train_state(build_model(cfg, seed=5, device="cpu")))


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """Save A: the latest slot after epoch 0 of a fresh fit. Save B: the
    one after epoch 1 of a fit resumed from A, unbroken, with the renames
    of its first save recorded."""
    cfg, root = _cfg(), tmp_path_factory.mktemp("slots")
    data = _data(cfg)
    loop.fit(build_model(cfg, seed=0, device="cpu"), data, workdir=str(root / "a"), epochs=1)
    shutil.copytree(root / "a", root / "b")
    with pytest.MonkeyPatch.context() as mp:
        renames = _replace_killed_at(0, mp)
        loop.fit(build_model(cfg, seed=0, device="cpu"), data, workdir=str(root / "b"), epochs=2,
                 resume=True)
    return cfg, data, root, renames


def _assert_same_save(got, want):
    assert got.step == want.step
    assert got.params.keys() == want.params.keys()
    assert all(torch.equal(got.params[k], want.params[k]) for k in want.params)
    for field in ("mu", "nu"):
        g, w = getattr(got.opt_state, field), getattr(want.opt_state, field)
        assert all(torch.equal(g[k], w[k]) for k in w)
    assert torch.equal(got.opt_state.count, want.opt_state.count)


def _kill_a_save(saves, tmp_path, monkeypatch, kill_at, async_checkpoints):
    """Resume save A's workdir for an epoch, the save killed before its
    ``kill_at``-th rename; then check what is left, and resume from it."""
    cfg, data, root, renames = saves
    # One save renames exactly these files, in this order: kill_at covers
    # every point between its writes.
    assert tuple(renames[:3]) == SAVE_RENAMES
    wd = str(tmp_path / "wd")
    shutil.copytree(root / "a", wd)
    _replace_killed_at(kill_at, monkeypatch)
    with pytest.raises(OSError, match="killed"):
        loop.fit(build_model(cfg, seed=0, device="cpu"), data, workdir=wd, epochs=2, resume=True,
                 async_checkpoints=async_checkpoints)
    monkeypatch.undo()

    a, b = _slot(str(root / "a"), cfg), _slot(str(root / "b"), cfg)
    assert a.step < b.step
    whole = a if kill_at == 1 else b  # the state.pt rename is the save's commit point
    assert ckpt.has_checkpoint(wd, STAMP)
    _assert_same_save(_slot(wd, cfg), whole)
    # params.pt is complete either way: the save before (killed before its
    # rename) or this one.
    decoded = ckpt.load_params(wd, STAMP, build_model(cfg, seed=6, device="cpu"), slot="latest")
    want = a if kill_at <= 2 else b
    assert all(torch.equal(p, want.params[k]) for k, p in decoded.state_dict().items())

    # The resumed run starts at the epoch the slot's parameters finished.
    batches = data.num_batches(cfg.batch_size, train=True)
    res = loop.fit(build_model(cfg, seed=7, device="cpu"), data, workdir=wd, epochs=3, resume=True)
    start = whole.step // batches
    assert start == (1 if kill_at == 1 else 2)
    assert [h["epoch"] for h in res.history] == list(range(start, 3))
    assert res.state.step == 3 * batches


@pytest.mark.parametrize("kill_at", [1, 2, 3])
def test_save_killed_between_its_writes_leaves_one_whole_save(saves, tmp_path, monkeypatch,
                                                              kill_at):
    _kill_a_save(saves, tmp_path, monkeypatch, kill_at, async_checkpoints=False)


@pytest.mark.parametrize("kill_at", [1, 2, 3])
def test_async_save_killed_between_its_writes_leaves_one_whole_save(saves, tmp_path,
                                                                    monkeypatch, kill_at):
    """The same kill in the background writer: its job writes the slot
    and then the fitmeta, and the failure reaches fit, which stops."""
    _kill_a_save(saves, tmp_path, monkeypatch, kill_at, async_checkpoints=True)


def test_a_slot_is_its_state_file(tmp_path):
    """A params.pt alone (as decode writes it) is no train-state slot; the
    state file alone is one, and holds the parameters params.pt holds."""
    cfg = _cfg()
    model = build_model(cfg, seed=1, device="cpu")
    wd = str(tmp_path)
    ckpt.save_params(wd, STAMP, model, slot="latest")
    assert not ckpt.has_checkpoint(wd, STAMP)
    state = create_train_state(model)
    ckpt.save_train_state(wd, STAMP, state)
    os.remove(ckpt.params_path(wd, STAMP, "latest"))
    assert ckpt.has_checkpoint(wd, STAMP)
    _assert_same_save(_slot(wd, cfg), state)
