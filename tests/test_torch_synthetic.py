"""The port's synthetic fixtures (``mgr_tpu_torch/data/synthetic.py``)
against the JAX package's: every maker and ``write_label_csv`` write the
same bytes for the same arguments (two seeds each), and ``reuse=True``
skips a completed run in both; and the ported example
(``mgr_tpu_torch/examples/synthetic_end_to_end.py``) at 2 epochs on the
CPU writes both MLFs and prints its MLF scoring.
"""

import os

import numpy as np
import pytest
import torch

from mgr_tpu.data import synthetic as jsyn
from mgr_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


MONO_LABELS = {1: [3, 5], 2: [7], 4: [2, 2, 9]}  # make_monolithic_audio_dataset's labels


def _make(mod, maker, root, kw):
    os.makedirs(root, exist_ok=True)
    if maker == "monolithic_audio":
        return mod.make_monolithic_audio_dataset(root, MONO_LABELS, **kw)
    return getattr(mod, f"make_{maker}_dataset")(root, **kw)


def _rel(result, root):
    """A maker's result with the output root taken out of its paths."""
    items = result if isinstance(result, tuple) else (result,)
    return [x.replace(root, "") if isinstance(x, str) else x for x in items]


CASES = {
    "audio": dict(n_files=3, frames_per_label=7, max_labels=3),
    "skeletal": dict(n_files=4, frames_per_label=5, max_labels=2, min_labels=2),
    "monolithic_audio": dict(frames_per_label=6),
    "rgb": dict(n_files=2, frames_per_label=3, max_labels=2, img_dim=12),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("maker", sorted(CASES))
def test_makers_write_jax_bytes(tmp_path, maker, seed):
    kw = dict(CASES[maker], seed=seed)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jout = _make(jsyn, maker, jroot, kw)
    tout = _make(tsyn, maker, troot, kw)
    want, got = _tree(jroot), _tree(troot)
    assert want and got == want
    assert _rel(tout, troot) == _rel(jout, jroot)


@pytest.mark.parametrize("seed", [0, 7])
def test_write_label_csv_writes_jax_bytes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    labels = {int(f): rng.integers(1, 21, size=rng.integers(0, 5)).tolist()
              for f in rng.permutation(40)[:9]}
    jsyn.write_label_csv(str(tmp_path / "j.csv"), labels)
    tsyn.write_label_csv(str(tmp_path / "t.csv"), labels)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("maker", sorted(CASES))
def test_reuse_skips_a_completed_run_as_in_jax(tmp_path, maker):
    kw = dict(CASES[maker], seed=3, reuse=True)
    for side, mod in (("jax", jsyn), ("torch", tsyn)):
        root = str(tmp_path / side)
        first = _make(mod, maker, root, kw)
        before = _tree(root)
        # A file edited after the run: a reuse leaves it as it is.
        victim = sorted(k for k in before if not k.startswith("."))[0]
        with open(os.path.join(root, victim), "ab") as f:
            f.write(b"#")
        second = _make(mod, maker, root, kw)
        after = _tree(root)
        assert after[victim] == before[victim] + b"#"
        assert {k for k in after if k.startswith(".")} == {k for k in before if k.startswith(".")}
        assert _rel(second, root) == _rel(first, root)
    assert sorted(_tree(tmp_path / "torch")) == sorted(_tree(tmp_path / "jax"))


def test_example_main_on_the_cpu_writes_both_mlfs(tmp_path, monkeypatch, capsys):
    from mgr_tpu_torch.decode import read_mlf
    from mgr_tpu_torch.examples import synthetic_end_to_end as example

    monkeypatch.setenv("MGR_TPU_EXAMPLE_EPOCHS", "2")
    out = example.main(str(tmp_path / "wd"), device="cpu")
    printed = capsys.readouterr().out
    assert "MLF scoring:" in printed and "in-framework train-split accuracy:" in printed
    assert out["epochs"] == 2
    refs = read_mlf(tmp_path / "wd" / "refs.mlf")
    hyps = read_mlf(tmp_path / "wd" / "sk_ctc_recout.mlf")
    assert sorted(refs) == [f"Sample{i:05d}" for i in range(1, 9)]
    assert set(hyps) <= set(refs) and len(hyps) == 2  # the validation split
    assert (tmp_path / "wd" / "skeletal_best.params.pt").is_file()
