"""The port's GSPMD route (a model axis above 2, a time axis) held against
the JAX package's GSPMD step and against the port's single-process step.

JAX's GSPMD step is its plain ``jax.jit`` step, partitioned by XLA over
the virtual CPU devices of ``tests/conftest.py`` (set up as
``tests/test_sharding.py:62-101``); the port's is a mesh of gloo CPU ranks
(``parallel.spawn.run_ranks``; rank bodies in ``torch_parallel_ranks.py``,
cases in ``torch_mesh_cases.py``), one rank launch a mesh shape, on the
same weights (the port's seeded init, bridged to JAX). Speech runs with
noise and dropout on: the GSPMD step's draws are one process's (the key is
not folded by the data index), so the ranks replay JAX's draws, recorded
at the global shapes while the port's single-process step drew them.
Meshes: 1x4 (H=8 in blocks of 2), 2x1x2 (time slices, the recurrence
whole on every rank), 1x2x2 (H in blocks of 4 and time slices: not the
direction-sharded route) and 1x3 (3 does not divide H=8: every rank runs
the whole layer, as JAX replicates the leaves).

Tolerances, each with its reason:
  * f32, ``tests/test_sharding.py``'s: loss rtol 1e-5; parameters after one
    step rtol 2e-4, atol 2e-5; against JAX's GSPMD step and against the
    port's single-process step. Raw gradients (which Adam's first update,
    -lr * sign(g), would hide a constant factor in) rtol 1e-4, atol 1e-6
    against JAX's single-device ``_loss_and_grads`` and the port's
    single-process ones, and the eval loss rtol 1e-5 against the port's:
    f32 sums in another order (the exchanges are exact).
  * bf16 (speech on 1x4) against the port's single-process bf16 step, K1/K2's
    plain versions: loss 1e-3 relative, raw gradients per leaf within
    1e-2 relative Frobenius (bf16 operands rounded at the same places, f32
    sums in another order and over other partitions; the H-sharded
    backward reads f32 residuals where K2 reads the bf16 streams), the
    parameters by ``test_torch_train._params_close``'s rule.
  * every family (early fusion, late fusion, rgb) on 1x4 and 2x1x2 with
    the port's own draws, against the port's single-process step: the f32
    tolerances above; late fusion's frozen encoders bit-unchanged, their
    gradients exactly 0.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
from mgr_tpu.core import config as cfglib
from mgr_tpu.parallel import make_mesh as jmake_mesh
from mgr_tpu.parallel.sharding import param_pspecs as jparam_pspecs
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.parallel import mesh as tmesh
from mgr_tpu_torch.parallel import sharding
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import loop as tloop
from mgr_tpu_torch.train import step as tstep
from test_torch_train import _params_close
from torch_mesh_cases import ranks

FAMILIES = ("early_fusion", "late_fusion", "rgb")
FAMILY_MESHES = ((1, 4, 1), (2, 1, 2))
BF16_MESH = (1, 4, 1)
NAN_MESHES = {(1, 2, 2): False, (1, 4, 1): True}  # mesh -> NaN in rank 0's backward
FIT_MESH = (1, 2, 2)
TOL_LOSS_BF16 = 1e-3
TOL_GRAD_BF16 = 1e-2


def _payload(c):
    return {k: c[k] for k in ("cfg", "sources", "params", "batch", "key", "draws")}


def _fit_case(tmp):
    """Speech (noise and dropout on) on 8 + 4 files at B=4: 2 steps an
    epoch."""
    c = mc.gspmd_case("speech", seed=9)
    b = mc.family_batch(c["jcfg"], seed=33, n=12)
    ids = list(range(1, 13))
    corpus = (b["inputs"], b["labels"], b["label_length"], b["input_length"], ids, ids[:8],
              ids[8:])
    return {"cfg": c["cfg"], "jcfg": c["jcfg"], "params": c["params"], "corpus": corpus,
            "workdir": str(tmp / "mesh")}


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """JAX's references, the port's single-process steps and one rank
    launch a mesh shape."""
    speech = mc.gspmd_case("speech")
    with mc.jax_draws() as draws:
        single = mc.port_step(speech)
    speech["draws"] = draws
    bf16 = mc.gspmd_case("speech", "bfloat16")
    with mc.jax_draws() as draws:
        single_bf16 = mc.port_step(bf16)
    bf16["draws"] = draws
    families = [mc.gspmd_case(name, seed=1 + i) for i, name in enumerate(FAMILIES)]
    family_single = [mc.port_step(c) for c in families]
    jloss, jgrads = mc.jax_single_grads(speech)
    jsteps = {shape: mc.jax_gspmd_step(speech, shape) for shape in mc.GSPMD_MESHES}

    nan_batch = {k: v.copy() for k, v in speech["batch"].items()}
    nan_batch["inputs"][0, 0, 0] = np.nan  # rank 0's rows and time slice only
    fit = _fit_case(tmp_path_factory.mktemp("gspmd_fit"))
    runs = {}
    for shape in mc.GSPMD_MESHES:
        cases = [speech] + ([bf16] if shape == BF16_MESH else []) + (
            families if shape in FAMILY_MESHES else [])
        nans = [] if shape not in NAN_MESHES else [{
            "cfg": speech["cfg"], "params": speech["params"], "key": speech["key"],
            "nan_dz": NAN_MESHES[shape],
            "batch": speech["batch"] if NAN_MESHES[shape] else nan_batch}]
        runs[shape] = run_ranks(
            ranks.gspmd_rank, int(np.prod(shape)),
            (shape, [_payload(c) for c in cases], nans,
             {k: fit[k] for k in ("cfg", "params", "corpus", "workdir")}
             if shape == FIT_MESH else None),
            timeout_s=mc.TIMEOUT_S)
    return {"single": single, "single_bf16": single_bf16, "jloss": jloss, "jgrads": jgrads,
            "jsteps": jsteps, "families": family_single, "runs": runs, "fit": fit}


def _steps(gspmd, shape, i):
    return [r["steps"][i] for r in gspmd["runs"][shape]]


def _check_f32(results, want, frozen=()):
    """Raw loss and gradients, eval loss, the step's loss and parameters
    of every rank against ``want`` (the port's single-process step); the
    ranks on one replica."""
    for r in results:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["eval"], want["eval"], rtol=1e-5)
        np.testing.assert_allclose(r["step_loss"], want["step_loss"], rtol=1e-5)
        assert r["grads"].keys() == want["grads"].keys()
        for k, w in want["grads"].items():
            if k in frozen:
                assert not r["grads"][k].any() and not w.any(), k
            else:
                np.testing.assert_allclose(r["grads"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        for k, w in want["params"].items():
            np.testing.assert_allclose(r["params"][k], w, rtol=2e-4, atol=2e-5, err_msg=k)
    for r in results[1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, results[0]["params"][k], err_msg=k)


@pytest.mark.parametrize("shape", mc.GSPMD_MESHES)
def test_speech_step_matches_jax_gspmd_step_and_one_process(gspmd, shape):
    """With noise and dropout on: the raw loss and gradients against JAX's
    single-device ones, the step against JAX's GSPMD step on the same
    mesh, and all of it against the port's single-process step."""
    results = _steps(gspmd, shape, 0)
    _check_f32(results, gspmd["single"])
    jloss, jparams = gspmd["jsteps"][shape]
    for r in results:
        np.testing.assert_allclose(r["loss"], gspmd["jloss"], rtol=1e-5)
        for k, w in gspmd["jgrads"].items():
            np.testing.assert_allclose(r["grads"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["step_loss"], jloss, rtol=1e-5)
        assert r["params"].keys() == jparams.keys()
        for k, w in jparams.items():
            np.testing.assert_allclose(r["params"][k], w, rtol=2e-4, atol=2e-5, err_msg=k)


# What each mesh runs for speech (T=12, two BiLSTM(8) layers), per raw
# step: H-sharded scans, K1/K2 calls (forward, backward), and all-reduces:
# one exchange a time step a layer in the forward and one in the backward,
# a time gather per layer and its transpose, and the combination of the
# loss and gradients.
ROUTES = {(1, 4, 1): (2, 0, 2 * 2 * mc.T + 1),
          (1, 2, 2): (2, 0, 2 * 2 * mc.T + 2 * 2 + 1),
          (2, 1, 2): (0, 2, 2 * 2 + 1),
          (1, 3, 1): (0, 2, 1)}


@pytest.mark.parametrize("shape", mc.GSPMD_MESHES)
def test_route_and_exchanges_per_mesh(gspmd, shape):
    """1x4 and 1x2x2 run the H-sharded recurrence and never K1/K2; 2x1x2
    and 1x3 run K1/K2 on every rank; no mesh runs the direction-sharded
    K5a/K5b; the all-reduces are exactly one a time step a layer each way
    (plus the time gathers and the combination)."""
    scans, k12, reduces = ROUTES[shape]
    for r in _steps(gspmd, shape, 0):
        c = r["calls"]
        assert c["hsharded_steps"] == scans, c
        assert c["bilstm_tm_streams"] == c["bilstm_tm_bwd"] == k12, c
        assert c["lstm_tm_streams"] == c["lstm_tm_bwd"] == 0, c
        assert r["all_reduces"] == reduces, r["all_reduces"]


def test_bf16_step_on_1x4_matches_one_process(gspmd):
    lr = mc.gspmd_cfg("speech")[0].optimizer.learning_rate
    want = gspmd["single_bf16"]
    for r in _steps(gspmd, BF16_MESH, 1):
        assert abs(r["loss"] - want["loss"]) <= TOL_LOSS_BF16 * abs(want["loss"])
        assert abs(r["step_loss"] - want["step_loss"]) <= TOL_LOSS_BF16 * abs(want["loss"])
        for k, w in want["grads"].items():
            rel = np.linalg.norm(r["grads"][k] - w) / np.linalg.norm(w)
            assert rel <= TOL_GRAD_BF16, (k, rel)
        diff = np.concatenate([np.abs(r["params"][k] - w).ravel()
                               for k, w in want["params"].items()])
        _params_close(diff, np.zeros_like(diff), 2 * lr)


@pytest.mark.parametrize("shape", FAMILY_MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_step_matches_one_process(gspmd, family, shape):
    """Each family's GSPMD step with the port's own draws against its
    single-process step. On 1x4 late fusion's skeletal encoder (H=6) runs
    whole through K1/K2 on every rank beside its H-sharded layers; on 2x1x2
    every layer runs through K1/K2. The frozen encoders come out
    bit-unchanged."""
    i = FAMILIES.index(family)
    offset = 2 if shape == BF16_MESH else 1
    results = _steps(gspmd, shape, offset + i)
    frozen = set(results[0]["frozen"])
    assert bool(frozen) == (family == "late_fusion")
    _check_f32(results, gspmd["families"][i], frozen)
    for r in results:
        assert r["frozen_unchanged"]
        c = r["calls"]
        if shape == (1, 4, 1):
            assert c["hsharded_steps"] > 0, c
            assert (c["bilstm_tm_streams"] > 0) == (family == "late_fusion"), c
        else:
            assert c["hsharded_steps"] == 0 and c["bilstm_tm_streams"] > 0, c


@pytest.mark.parametrize("shape", sorted(NAN_MESHES))
def test_debug_nans_raises_on_every_rank(gspmd, shape):
    """Under ``debug_nans``: a NaN in rank 0's rows and time slice (1x2x2)
    reaches every rank through the time gather, and every rank raises at
    the loss; a NaN made in rank 0's backward of the H-sharded recurrence
    alone (1x4) runs on through the per-step exchanges, and every rank
    raises at the combined gradients' norm. No rank waits for another."""
    want = "gradient norm is not finite" if NAN_MESHES[shape] else "loss"
    for r in gspmd["runs"][shape]:
        (nan,) = r["nans"]
        assert nan["raised"] and want in nan["raised"], nan
        assert nan["seconds"] < 60


def test_fit_over_1x2x2_resumes_and_matches_one_process(gspmd, tmp_path):
    """``fit`` over 1x2x2 for 2 epochs, then resumed to 3: rank 0 alone
    writes, the ranks end equal, and the losses are the single-process
    ``fit``'s (the same draws: the key is not folded)."""
    fit = gspmd["fit"]
    out = [r["fit"] for r in gspmd["runs"][FIT_MESH]]
    assert out[0]["writes"] == ["speech"] and not any(o["writes"] for o in out[1:])
    assert len({o["digest"] for o in out}) == 1 and out[0]["step"] == 6
    cfg = mc._port(fit["jcfg"])
    data = Batcher(*fit["corpus"][:5], train_ids=fit["corpus"][5], val_ids=fit["corpus"][6])
    history = []
    for epochs, resume in ((2, False), (3, True)):
        model = bridge.load_params(tbuild(cfg, device="cpu"), fit["params"])
        res = tloop.fit(model, data, workdir=str(tmp_path), epochs=epochs, resume=resume)
        history += [[h[k] for k in ("train_loss", "val_loss")] for h in res.history]
    assert len(out[0]["history"]) == len(history) == 3
    np.testing.assert_allclose(out[0]["history"], history, rtol=1e-5)


# ------------------------------------------------------------ layout helpers


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 1), (2, 1, 2)])
def test_rank_layout_is_jax_make_mesh_order(shape):
    """Rank r sits where JAX's ``make_mesh`` puts device r."""
    jm = jmake_mesh(cfglib.MeshConfig(*shape))
    grid = np.vectorize(lambda d: d.id)(jm.devices).reshape(shape)
    for rank in range(int(np.prod(shape))):
        m = tmesh.Mesh(tconfig.MeshConfig(*shape), rank, torch.device("cpu"), None, None, None)
        assert grid[m.data_index, m.model_index, m.time_index] == rank


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 3, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2)])
def test_param_pspecs_match_jax(shape):
    """The leaves whose H-block a rank computes are those JAX shards over
    ``model``: the BLSTM W, U, b of late fusion's H=8 and H=4 layers on a
    model axis of 4, every layer's on 1x2x2, its H=6 encoder's on 1x3;
    none on the shard_map route (2x2) or a model axis of 1."""
    c = mc.gspmd_case("late_fusion")
    jspecs = bridge.flatten(jparam_pspecs(jax.tree.map(np.asarray, c["params"]),
                                          jmake_mesh(cfglib.MeshConfig(*shape))))
    got = sharding.param_pspecs(bridge.flatten(c["params"]), tconfig.MeshConfig(*shape))
    assert got.keys() == jspecs.keys()
    for k, spec in jspecs.items():
        assert got[k] == (spec[-1] if len(spec) else None), (k, got[k], spec)
    assert any(got.values()) == (shape not in ((2, 2, 1), (2, 1, 2)))


def test_shard_batch_splits_rows_and_time_as_jax_places_them():
    class M:
        data, data_index, time, time_index = 2, 1, 2, 0

    batch = {"inputs": np.arange(4 * 6 * 2).reshape(4, 6, 2), "labels": np.arange(8).reshape(4, 2)}
    got = sharding.shard_batch(batch, M())
    np.testing.assert_array_equal(got["inputs"], batch["inputs"][2:, :3])
    np.testing.assert_array_equal(got["labels"], batch["labels"][2:])
    with pytest.raises(ValueError, match="time ranks"):  # JAX's device_put refuses it too
        sharding.shard_batch({"inputs": np.zeros((4, 5, 2))}, M())


def test_gspmd_warning_once_per_mesh_shape(caplog, monkeypatch):
    monkeypatch.setattr(tstep, "_warned_mesh_shapes", [])
    model = tbuild(mc._port(mc.gspmd_cfg("speech")[0]), device="cpu")
    with caplog.at_level(logging.WARNING):
        for shape in ((1, 4, 1), (1, 4, 1), (1, 2, 2), (2, 2, 1)):
            m = tmesh.Mesh(tconfig.MeshConfig(*shape), 0, torch.device("cpu"), None, None, None)
            tstep.make_train_step(model, mesh=m)
    said = [r.getMessage() for r in caplog.records if "GSPMD" in r.getMessage()]
    assert len(said) == 2 and "1x4x1" in said[0] and "1x2x2" in said[1]
    assert "one exchange of h over the model axis a time step" in said[0]
    assert "no K1/K2" in said[0]
