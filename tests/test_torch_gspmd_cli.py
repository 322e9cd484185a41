"""The GSPMD route through ``run_curriculum(mesh=)`` and the CLI:
``run_curriculum`` over a 1x2x2 gloo mesh of CPU ranks against the port's
single-process curriculum, ``train speech --mesh 1x4`` and ``--mesh
2x1x2`` under torchrun against ``train speech`` in one process, and
``decode speech`` of the 1x4 workdir over its stored mesh against the same
command in one process.

Tolerances: the ranks agree bit for bit; the losses of the mesh runs are
the single-process ones within rtol 1e-5 (f32 sums in another order; the
GSPMD step's draws are one process's, so noise and dropout stay on); the
MLF of the 4-process decode is the 1-process one's, byte for byte (a
stored GSPMD mesh decodes with the one-process step on every rank).
"""

import json

import numpy as np
import pytest

import torch_mesh_cases as mc
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import curriculum as tcurriculum
from test_torch_mesh_curriculum import STAGES, _configs, _history, corpus  # noqa: F401
from torch_mesh_cases import ranks


def test_run_curriculum_over_1x2x2_matches_the_single_process_one(corpus, tmp_path):  # noqa: F811
    """Rank 0 alone writes the three stages' slots; the ranks end every
    stage on the same parameters; each stage's losses are the
    single-process curriculum's."""
    cfgs = {k: mc._port(v) for k, v in _configs().items()}
    out = run_ranks(ranks.curriculum_rank, 4,
                    ({k: v.to_json() for k, v in cfgs.items()}, corpus, str(tmp_path / "mesh"),
                     (1, 2, 2)), timeout_s=mc.TIMEOUT_S)
    assert out[0]["writes"] == sorted(STAGES) and not any(o["writes"] for o in out[1:])
    for stage in STAGES:
        assert len({o["stages"][stage]["digest"] for o in out}) == 1, stage
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


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gspmd_cli"))
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        root, n_files=10, frames_per_label=30, seed=8)
    return ["--data-dir", audio_dir, "--labels", audio_labels, "--device", "cpu"]


def test_train_over_gspmd_meshes_and_decode_on_the_stored_mesh(audio, tmp_path):
    """`train speech` (the preset at test size: noise and dropout on,
    BiLSTM(8)x2, T=24) with `--mesh 1x4` and `--mesh 2x1x2` on 4 processes
    started by torchrun: one result line (rank 0's), the mesh in the stored
    config, the best val loss of `train` in one process. Then `decode
    speech` of the 1x4 workdir on 4 processes (its stored mesh) and in one:
    the same MLF."""
    train = ["train", "speech", "--epochs", "2", "--batch-size", "2",
             "--compute-dtype", "float32", *audio]
    want = json.loads(mc.cli([*train, "--workdir", str(tmp_path / "one")], 1, tmp_path)[0])
    for mesh in ("1x4", "2x1x2"):
        wd = tmp_path / mesh
        lines = mc.cli([*train, "--mesh", mesh, "--workdir", str(wd)], 4, tmp_path)
        assert len(lines) == 1, lines
        got = json.loads(lines[0])
        assert got["epochs_run"] == want["epochs_run"] == 2
        np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-5)
        stored = json.load(open(wd / "speech_config.json"))["mesh"]
        assert [stored[k] for k in ("data", "model", "time")] == [int(x) for x in
                                                                   mesh.split("x") + ["1"]][:3]
    mlfs = {}
    for procs in (4, 1):
        out = str(tmp_path / f"p{procs}.mlf")
        lines = mc.cli(["decode", "speech", "--workdir", str(tmp_path / "1x4"), "--out", out,
                        *audio], procs, tmp_path)
        assert len(lines) == 1 and '"decoded": 10' in lines[0], lines
        mlfs[procs] = open(out).read()
    assert mlfs[4] == mlfs[1] and mlfs[1].count("_audio.rec") == 10
