"""Decode over a mesh of ranks: ``make_decode_step(model, ..., mesh=)`` on
2x1 and 2x2 gloo meshes of CPU ranks against the JAX package's
``make_decode_step(jmodel, ..., mesh=)`` on its virtual CPU devices, for
one stream (speech) and two (early fusion), with and without the input
lengths; and ``decode speech`` of a workdir trained over a 2x1 mesh,
started on 2 processes by torchrun, against the same command in one
process.

``best`` and ``emit`` must be JAX's exactly: the posteriors are f32 on
both sides, and every frame's top-2 margin is checked to be far above
their difference (f32 sums in another order), so no argmax can flip.
The MLF of the 2-process decode must be the 1-process one's, byte for
byte.
"""

import jax
import numpy as np
import pytest

import torch_mesh_cases as mc
from mgr_tpu.core import config as cfglib
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.parallel import make_mesh as jmake_mesh
from mgr_tpu.parallel import shard_params as jshard_params
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import step as tstep
from torch_mesh_cases import ranks

FAMILIES = ("speech", "early_fusion")
# Between the smallest and the largest frame maximum of each case's
# near-uniform posteriors: some frames clear it and some do not.
THRESHOLDS = {"speech": 0.02305, "early_fusion": 0.0462}


def _cases():
    out = []
    for i, name in enumerate(FAMILIES):
        c = mc.case(name, seed=20 + i)
        c["threshold"] = THRESHOLDS[name]
        out.append(c)
    return out


@pytest.fixture(scope="module")
def decoded():
    cases = _cases()
    payload = [{k: c[k] for k in ("cfg", "sources", "params", "batch", "threshold")}
               for c in cases]
    return cases, {shape: run_ranks(ranks.decode_rank, shape[0] * shape[1], (shape, payload),
                                    timeout_s=mc.TIMEOUT_S) for shape in mc.MESHES}


def _inputs(batch):
    return (batch["inputs"], batch["inputs2"]) if "inputs2" in batch else batch["inputs"]


@pytest.mark.parametrize("shape", mc.MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_decode_matches_jax_mesh_decode(decoded, family, shape):
    cases, out = decoded
    i = FAMILIES.index(family)
    c = cases[i]
    jmodel = jbuild(c["jcfg"])
    mesh = jmake_mesh(cfglib.MeshConfig(*shape))
    params = jshard_params(mc._to_jax(c["params"]), mesh)
    step = jstep.make_decode_step(jmodel, threshold=c["threshold"], mesh=mesh)
    inputs = _inputs(c["batch"])
    # No argmax can flip between the two frameworks' f32 posteriors.
    tmodel = bridge.load_params(tbuild(mc._port(c["jcfg"]), device="cpu"), c["params"])
    got = tstep.make_predict_step(tmodel)(inputs).numpy()
    want = np.asarray(jax.jit(jstep.make_predict_step(jmodel))(params, inputs))
    diff = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * diff
    assert np.abs(top2[..., 1] - c["threshold"]).min() > 10 * diff
    for j, lengths in enumerate((None, c["batch"]["input_length"])):
        jbest, jemit = (np.asarray(a) for a in step(params, inputs, lengths))
        assert 0 < jemit.sum() < jemit.size  # the threshold and the collapse both act
        for r in out[shape]:
            best, emit = r[i][j]
            np.testing.assert_array_equal(best, jbest)
            np.testing.assert_array_equal(emit, jemit)


def test_decode_cli_on_the_stored_mesh_gives_the_single_process_mlf(tmp_path):
    root = str(tmp_path / "corpus")
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        root, n_files=10, frames_per_label=30, seed=8)
    wd = str(tmp_path / "wd")
    data = ["--data-dir", audio_dir, "--labels", audio_labels, "--device", "cpu"]
    lines = mc.cli(["train", "speech", "--mesh", "2x1", "--workdir", wd, "--epochs", "2",
                  "--batch-size", "2", "--compute-dtype", "float32", *data], 2, tmp_path)
    assert len(lines) == 1 and '"data": 2' in open(f"{wd}/speech_config.json").read()
    mlfs = {}
    for procs in (2, 1):
        out = str(tmp_path / f"p{procs}.mlf")
        lines = mc.cli(["decode", "speech", "--workdir", wd, "--out", out, *data], procs, tmp_path)
        assert len(lines) == 1 and '"decoded": 10' in lines[0], lines
        mlfs[procs] = open(out).read()
    assert mlfs[2] == mlfs[1] and mlfs[1].count("_audio.rec") == 10
