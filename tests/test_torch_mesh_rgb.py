"""The rgb family over a mesh of ranks: the CNN frontend (remat on)
replicated on both ranks of a model pair, the BiLSTM on its features by
the port's mesh steps on 2x1 and 2x2 gloo meshes of CPU ranks, held
against the JAX package's shard_map steps (tolerances in
``tests/torch_mesh_cases.py``); and ``fit`` over a 2x2 mesh on a lazy video
corpus (``LazyVideoBatcher``: every rank reads the whole global batch and
keeps its rows), whose ranks must agree bit for bit and whose losses must
be the single-process ``fit``'s within rtol 1e-5 (f32 sums in another
order).
"""

import numpy as np
import pytest

import torch_mesh_cases as mc
from mgr_tpu_torch import bridge
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import loop as tloop
from torch_mesh_cases import ranks

FAMILIES = ("rgb",)


@pytest.fixture(scope="module")
def meshes():
    return mc.run_meshes(FAMILIES)


@pytest.mark.parametrize("shape", mc.MESHES)
def test_mesh_step_matches_jax_mesh_step(meshes, shape):
    mc.check_step(meshes, "rgb", shape)


@pytest.mark.parametrize("shape", mc.MESHES)
def test_mesh_raw_grads_match_jax_single_device(meshes, shape):
    """rgb's CNN gradients reach the mean over the model group as twice
    the half that came through the rank's direction."""
    mc.check_raw_grads(meshes, "rgb", shape)


@pytest.mark.parametrize("shape", mc.MESHES)
def test_mesh_step_takes_the_recurrence_of_its_mesh(meshes, shape):
    mc.check_calls(meshes, "rgb", shape)


def test_bf16_mesh_step_matches_jax(meshes, monkeypatch):
    mc.check_bf16(meshes, "rgb", monkeypatch)


def test_fit_over_a_2x2_mesh_on_a_lazy_video_corpus(tmp_path):
    root = str(tmp_path / "videos")
    videos = synthetic.make_rgb_dataset(root, n_files=10, img_dim=mc.D, frames_per_label=2,
                                        max_labels=2, seed=6)[:2]
    cfg, _ = mc.family_cfg("rgb", batch=2)
    weights = mc.port_weights(cfg, None, 4)
    case = {"tag": "rgb", "cfg": cfg.to_json(), "params": weights, "videos": videos}
    out = run_ranks(ranks.fit_families_rank, 4, ((2, 2), [case], str(tmp_path)),
                    timeout_s=mc.TIMEOUT_S)
    got = [r[0] for r in out]
    assert len({g["digest"] for g in got}) == 1
    model = bridge.load_params(tbuild(mc._port(cfg), device="cpu"), weights)
    single = tloop.fit(model, tdatasets.build_rgb_dataset(*videos, mc._port(cfg)), epochs=2)
    assert got[0]["step"] == single.state.step > 2
    for g, s in zip(got[0]["history"], single.history):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], s[key], rtol=1e-5, err_msg=key)
