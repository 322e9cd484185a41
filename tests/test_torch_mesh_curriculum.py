"""``fit`` and the curriculum over a mesh of ranks: early fusion's ``fit``
over a 2x2 gloo mesh of CPU ranks on host batches and on the
device-resident corpus, ``run_curriculum(mesh=)`` over a 2x1 mesh against
the port's single-process curriculum (which ``tests/test_torch_curriculum.py``
holds against JAX's), and ``train early_fusion``, ``train rgb`` and
``curriculum`` under torchrun with ``--mesh 2x1 --device cpu``.

Tolerances: the ranks agree bit for bit; the losses of the mesh runs are
the single-process ones within rtol 1e-5 (f32 sums in another order: each
rank sums its own rows); ``fit(device_data=True, mesh=)`` runs the
single-process step on every rank, so it is the single-process ``fit``
bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
from mgr_tpu.core import config as cfglib
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import curriculum as tcurriculum
from mgr_tpu_torch.train import loop as tloop
from torch_mesh_cases import ranks

STAGES = ("speech", "skeletal", "late_fusion")


def _history(res):
    return [{k: h[k] for k in ("train_loss", "val_loss")} for h in res.history]


def test_fit_over_a_2x2_mesh_matches_the_single_process_fit(tmp_path):
    """Early fusion on host batches (each rank keeps its rows of both
    streams) and on the device-resident corpus (every rank trains the
    whole batch, as JAX's indexed steps do on a mesh)."""
    cfg, _ = mc.family_cfg("early_fusion")
    weights = mc.port_weights(cfg, None, 3)
    b = mc.family_batch(cfg, seed=31, n=12)
    ids = list(range(1, 13))
    corpus = ((b["inputs"], b["inputs2"]), b["labels"], b["label_length"], b["input_length"],
              ids, ids[:8], ids[8:])
    cases = [{"tag": "host", "cfg": cfg.to_json(), "params": weights, "corpus": corpus},
             {"tag": "device", "cfg": cfg.to_json(), "params": weights, "corpus": corpus,
              "device_data": True}]
    out = run_ranks(ranks.fit_families_rank, 4, ((2, 2), cases, str(tmp_path)),
                    timeout_s=mc.TIMEOUT_S)
    model = bridge.load_params(tbuild(mc._port(cfg), device="cpu"), weights)
    single = tloop.fit(model, Batcher(*corpus), epochs=2)
    for j, c in enumerate(cases):
        got = [r[j] for r in out]
        assert len({g["digest"] for g in got}) == 1, c["tag"]
        assert got[0]["step"] == single.state.step == 4
        for g, s in zip(got[0]["history"], single.history):
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(g[key], s[key], rtol=1e-5, err_msg=(c["tag"], key))
    assert out[0][1]["digest"] == ranks._digest(dict(model.named_parameters()))
    assert out[0][1]["history"] == _history(single)
    assert os.path.exists(tmp_path / "device" / "early_fusion_best.params.pt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Skeletal CSV + labels and per-file audio CSVs (5x the frame rate)
    + their labels, for the same ten files."""
    root = str(tmp_path_factory.mktemp("mesh_curriculum"))
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=10, frames_per_label=6, seed=7)
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        root, labels=labels, frames_per_label=30, seed=8)
    return dict(sk_csv=sk_csv, labels=sk_labels, audio_dir=audio_dir,
                audio_labels=audio_labels, sequences=labels)


def _configs():
    """The three stages at test size, f32, noise and dropout off, batch 2
    (one row a rank)."""
    common = dict(maxlen=mc.T, batch_size=2, compute_dtype="float32", patience=50,
                  optimizer=cfglib.OptimizerConfig(learning_rate=0.05, decay=1e-5))
    return {
        "speech": cfglib.get_preset("speech").replace(
            max_label_len=12, encoder=cfglib.EncoderConfig(hidden=8, depth=2, **mc.OFF),
            **common),
        "skeletal": cfglib.get_preset("skeletal").replace(
            max_label_len=4, encoder=cfglib.EncoderConfig(hidden=6, depth=2, **mc.OFF),
            **common),
        "late_fusion": cfglib.get_preset("late_fusion").replace(
            max_label_len=4, fusion_hidden=4, fusion_dropout=0.0, fusion_output_dropout=0.0,
            encoder=cfglib.EncoderConfig(hidden=8, depth=2, **mc.OFF), **common),
    }


def test_run_curriculum_over_a_2x1_mesh_matches_the_single_process_one(corpus, tmp_path):
    """Rank 0 alone writes the three stages' slots; the ranks end every
    stage on the same parameters; each stage's losses are the
    single-process curriculum's; the fusion slot's encoders are the
    donors' best slots bit for bit."""
    cfgs = {k: mc._port(v) for k, v in _configs().items()}
    wd = str(tmp_path / "mesh")
    out = run_ranks(ranks.curriculum_rank, 2,
                    ({k: v.to_json() for k, v in cfgs.items()}, corpus, wd),
                    timeout_s=mc.TIMEOUT_S)
    assert out[0]["writes"] == sorted(STAGES) and out[1]["writes"] == []
    for stage in STAGES:
        assert out[0]["stages"][stage]["digest"] == out[1]["stages"][stage]["digest"], stage
    data = (tdatasets.build_audio_dataset(corpus["audio_dir"], corpus["audio_labels"],
                                          cfgs["speech"]),
            tdatasets.build_skeletal_dataset(corpus["sk_csv"], corpus["labels"],
                                             cfgs["skeletal"]),
            tdatasets.build_late_fusion_dataset(corpus["audio_dir"], corpus["sk_csv"],
                                                corpus["labels"], cfgs["late_fusion"]))
    single = tcurriculum.run_curriculum(*data, str(tmp_path / "single"), configs=cfgs,
                                        epochs=2, device="cpu")
    for stage in STAGES:
        got = out[0]["stages"][stage]["history"]
        assert len(got) == 2
        for g, s in zip(got, _history(single[stage])):
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(g[key], s[key], rtol=1e-5, err_msg=(stage, key))
    fused = tckpt.read_params(wd, "late_fusion")
    for name in ("speech", "skeletal"):
        for k, v in tckpt.read_params(wd, name).items():
            if k.startswith("encoder."):
                assert torch.equal(fused[f"{name}.{k[len('encoder.'):]}"], v), (name, k)


def test_train_and_curriculum_cli_on_a_mesh_under_torchrun(corpus, tmp_path):
    """`train early_fusion`, `train rgb` and `curriculum` with `--mesh 2x1
    --device cpu` on 2 processes (the port's CLI with test-size presets):
    one result line each (rank 0's), the slots in the workdir, the mesh
    in the stored config."""
    mono = synthetic.make_monolithic_audio_dataset(
        str(tmp_path), corpus["sequences"], frames_per_label=30, seed=5)
    videos, video_labels, _ = synthetic.make_rgb_dataset(
        str(tmp_path / "rgb"), n_files=10, img_dim=mc.D, frames_per_label=2, max_labels=2,
        seed=6)
    common = ["--mesh", "2x1", "--device", "cpu", "--epochs", "1", "--batch-size", "2",
              "--compute-dtype", "float32"]
    runs = {
        "early_fusion": ["train", "early_fusion", "--audio-csv", mono, "--skeletal-csv",
                         corpus["sk_csv"]],
        "rgb": ["train", "rgb", "--data-dir", videos, "--labels", video_labels],
        "curriculum": ["curriculum", "--audio-dir", corpus["audio_dir"], "--audio-labels",
                       corpus["audio_labels"], "--skeletal-csv", corpus["sk_csv"], "--labels",
                       corpus["labels"]],
    }
    for tag, argv in runs.items():
        wd = tmp_path / f"wd_{tag}"
        lines = mc.cli([*argv, "--workdir", str(wd), *common], 2, tmp_path)
        assert len(lines) == 1, (tag, lines)
        result = json.loads(lines[0])
        stamps = STAGES if tag == "curriculum" else (tag,)
        if tag == "curriculum":
            assert set(result) == set(STAGES) and all(v["epochs"] == 1 for v in result.values())
        else:
            assert result["epochs_run"] == 1
        for stamp in stamps:
            assert {f"{stamp}_best.params.pt", f"{stamp}_latest.state.pt"} <= set(os.listdir(wd))
            assert json.load(open(wd / f"{stamp}_config.json"))["mesh"]["data"] == 2, stamp
