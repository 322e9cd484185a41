"""The port's ``entry.dryrun_multichip`` (the counterpart of
``__graft_entry__.py::dryrun_multichip``) on gloo ranks on the CPU: its
five phases pass at 8 ranks (phase 1 on the GSPMD route's 2x2x2 mesh), 2
ranks (phase 1 direction-sharded on 1x2x1) and 3 (pure data parallelism,
no phase 3), each with JAX's tolerances and ``ok`` line; its self-checks
bite (a reference handed perturbed rows fails the run with the JAX
message's wording; a gradient outside a rank's part fails phase 1's
split check); and it does not run on the CPU unless asked."""

import re
from types import SimpleNamespace

import pytest
import torch

import torch_parallel_ranks
from mgr_tpu_torch import entry
from mgr_tpu_torch.core.config import MeshConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("n, mesh, split", [(8, "data:2 x model:2 x time:2", 6),
                                            (2, "data:1 x model:2 x time:1", 6),
                                            (3, "data:3 x model:1 x time:1", 0)])
def test_dryrun_multichip_passes_on_the_cpu(n, mesh, split, capsys):
    result = entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [result["line"]]
    assert re.match(rf"dryrun_multichip\({n}\): ok, loss=\d+\.\d{{4}}, mesh={mesh}; ",
                    result["line"]), result["line"]
    assert result["split_leaves_checked"] == split  # W, U, b of both BLSTM layers
    for phase in ("dp", "late_fusion") + (("tp",) if n % 2 == 0 else ()):
        r = result[phase]
        assert r["dloss"] < entry.TOL_LOSS_REL * max(1.0, abs(r["loss_1"]))
        assert r["dparams"] < entry.TOL_CHECKSUM_REL
    assert (result["tp"] is None) == (n % 2 == 1)
    assert result["decode_emitted"] >= 0
    assert set(result["launches"]) == {"1", "2", "4", "5"} | ({"3"} if n % 2 == 0 else set())
    assert not any(sum(c.values()) for c in result["launches"].values())  # no kernel on the CPU


def test_a_perturbed_reference_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(entry, "_dryrun_rank", torch_parallel_ranks.dryrun_perturbed_rank)
    with pytest.raises(RuntimeError, match="DP shard_map loss diverges from single device"):
        entry.dryrun_multichip(2, device="cpu")
    assert "ok" not in capsys.readouterr().out


@pytest.mark.parametrize("model, time, leaked", [(2, 1, None), (2, 1, "U"), (4, 1, None),
                                                 (4, 1, "W"), (2, 2, "b")])
def test_split_check(model, time, leaked):
    """Phase 1's check on a rank's BLSTM gradients: zero outside its
    direction's slot (model 2, time 1) or its H-block (the GSPMD route),
    nonzero inside; a leaked entry outside fails it."""
    cfg = MeshConfig(data=1, model=model, time=time)
    mesh = SimpleNamespace(config=cfg, model=model, model_index=1)
    H, gspmd = 8, model > 2 or time > 1
    grads = {"encoder.blstm_0.W": torch.zeros(2, 3, 4, H),
             "encoder.blstm_0.U": torch.zeros(2, H, 4, H),
             "encoder.blstm_0.b": torch.zeros(2, 4, H), "head.W": torch.ones(2 * H, 5)}
    n = H // model
    for g in grads.values():
        if g.ndim >= 3:
            (g[..., n:2 * n] if gspmd else g[1]).fill_(0.5)
    if leaked is None:
        assert entry._check_split(grads, mesh, rank=1) == 3
        return
    grads[f"encoder.blstm_0.{leaked}"][0, ..., 0] = 1e-6
    with pytest.raises(AssertionError, match=f"did not split encoder.blstm_0.{leaked}"):
        entry._check_split(grads, mesh, rank=1)


def test_without_a_card_it_does_not_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
