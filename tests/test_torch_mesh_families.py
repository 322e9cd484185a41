"""The fusion families over a mesh of ranks: early fusion (two streams,
each with its own noise key) and late fusion (frozen encoders under
``torch.no_grad()``, the fusion BiLSTM trained) by the port's mesh steps
on 2x1 (pure data parallelism) and 2x2 (data parallelism x
direction-sharded tensor parallelism) gloo meshes of CPU ranks, held
against the JAX package's shard_map steps on the virtual CPU devices of
``tests/conftest.py``; and ``debug_nans`` on a mesh.

The ranks run ``tests/torch_parallel_ranks.py`` (no JAX), one launch per
mesh shape for both families (``tests/torch_mesh_cases.py``, which states the
tolerances of the step checks). Under ``debug_nans`` every rank must
raise within 60 s.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
from mgr_tpu_torch.core import tracing
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import step as step_lib
from torch_mesh_cases import ranks

FAMILIES = ("early_fusion", "late_fusion")


@pytest.fixture(scope="module")
def meshes():
    return mc.run_meshes(FAMILIES)


@pytest.mark.parametrize("shape", mc.MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_step_matches_jax_mesh_step(meshes, family, shape):
    mc.check_step(meshes, family, shape)


@pytest.mark.parametrize("shape", mc.MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_raw_grads_match_jax_single_device(meshes, family, shape):
    mc.check_raw_grads(meshes, family, shape)


@pytest.mark.parametrize("shape", mc.MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_step_takes_the_recurrence_of_its_mesh(meshes, family, shape):
    mc.check_calls(meshes, family, shape)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_mesh_step_matches_jax(meshes, family, monkeypatch):
    mc.check_bf16(meshes, family, monkeypatch)


@pytest.mark.parametrize("shape", mc.MESHES)
def test_late_fusion_freeze_mask_gives_jax_optimizer_state(meshes, shape):
    """The frozen encoders' zero gradients leave Adam's moments at 0 on
    every rank, as JAX's freeze mask (it computes the gradients, then
    masks them) leaves its own; the trained leaves' moments agree."""
    i = FAMILIES.index("late_fusion")
    frozen, want = mc._frozen(meshes["f32"][i]), meshes["jax"]["late_fusion"][shape]
    assert frozen
    for r in (r[i] for r in meshes["ranks"][shape]):
        for moment in ("mu", "nu"):
            for k, w in want[moment].items():
                if k in frozen:
                    assert not r[moment][k].any() and not w.any(), (moment, k)
                else:
                    np.testing.assert_allclose(r[moment][k], w, rtol=2e-4, atol=1e-9,
                                               err_msg=(moment, k))


def test_debug_nans_on_a_mesh_raises_on_every_rank():
    """A NaN in rank 0's rows only: both ranks raise FloatingPointError at
    the same step, within seconds (no rank waits at a collective), and
    anomaly mode is off afterwards."""
    cfg, _ = mc.family_cfg("early_fusion")
    batch = mc.family_batch(cfg, seed=9)
    batch["inputs"][0, 3, 2] = np.nan
    out = run_ranks(ranks.nan_rank, 2, (cfg.to_json(), mc.port_weights(cfg, None, 5), batch),
                    timeout_s=120)
    for r in out:
        assert r["raised"] and r["raised"].startswith("FloatingPointError"), r
        assert r["seconds"] < 60 and not r["anomaly_after"], r


@pytest.mark.parametrize("model_axis", (1, 2), ids=("2x1", "2x2"))
def test_debug_nans_on_a_mesh_with_a_nan_in_one_directions_backward(model_axis):
    """The forward finite, rank 0 alone makes a NaN in direction 0's dz:
    on 2x1 anomaly mode's error in rank 0's backward, on 2x2 the norm of
    the combined gradients (the backward holds the model pair's
    exchanges, which a rank raising inside it would leave its partner
    waiting in). Every rank raises FloatingPointError within seconds."""
    cfg, _ = mc.family_cfg("early_fusion")
    batch = mc.family_batch(cfg, seed=9)
    out = run_ranks(ranks.nan_rank, 2 * model_axis,
                    (cfg.to_json(), mc.port_weights(cfg, None, 5), batch, model_axis, True),
                    timeout_s=120)
    for r in out:
        assert r["raised"] and r["raised"].startswith("FloatingPointError"), r
        assert r["seconds"] < 60 and not r["anomaly_after"], r
    want = "returned nan values" if model_axis == 1 else "gradient norm is not finite"
    assert want in out[0]["raised"], out[0]


def test_debug_nans_on_a_mesh_lets_any_other_error_through():
    """Under ``debug_nans`` a rank's error that is not a NaN verdict (a
    CUDA or collective fault) propagates as it is, with no flag
    all-reduce and no ``FloatingPointError`` in its place."""
    def fault():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    tracing.debug_nans(True)
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            step_lib._on_every_rank(SimpleNamespace(model=1, time=1, device="cpu"), fault)
    finally:
        tracing.debug_nans(False)
    assert not torch.is_anomaly_enabled()
