"""Rank bodies of the gloo mesh tests in ``tests/test_torch_parallel.py``.

Each function runs in a process spawned by
``mgr_tpu_torch.parallel.spawn.run_ranks``, inside an initialized gloo
process group on the CPU. This module imports no JAX and nothing of the
JAX package, so that a rank starts fast; results go back as numpy arrays.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core.config import MeshConfig, PipelineConfig
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.parallel import collectives
from mgr_tpu_torch.parallel.mesh import make_mesh
from mgr_tpu_torch.train import loop as loop_lib
from mgr_tpu_torch.train import step as step_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _numpy(tree):
    return {k: v.detach().float().numpy().copy() for k, v in tree.items()}


def gather_rank(rank, world, h, g):
    """The direction exchange: forward and backward on rank-specific h
    (T, B, H) and cotangents (2, T, B, H)."""
    x = torch.from_numpy(h[rank].copy()).requires_grad_()
    both = collectives.gather_directions(x, dist.group.WORLD, rank)
    (both * torch.from_numpy(g[rank])).sum().backward()
    return both.detach().numpy(), x.grad.numpy()


def layer_rank(rank, world, params, x, g, dtype):
    """One BLSTM layer under the direction-shard context (rank = direction):
    its output, and the gradients combined over the two ranks as the mesh
    step combines them."""
    p = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    calls = _spy()
    with dispatch.direction_shard(dist.group.WORLD, rank):
        out = tlstm.bilstm_layer_tm(p, torch.from_numpy(x), compute_dtype=DTYPES[dtype])
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = collectives.pmean_tree({k: t.grad for k, t in p.items()}, dist.group.WORLD)
    return out.detach().float().numpy(), _numpy(grads), dict(calls)


def _spy():
    """Count the calls of the recurrence wrappers: the two-direction
    (K1/K2) and the single-direction (K5a/K5b) ones."""
    calls = {"bilstm_tm_streams": 0, "bilstm_tm_bwd": 0, "lstm_tm_streams": 0,
             "lstm_tm_bwd": 0}
    for name in calls:
        real = getattr(k1, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        setattr(k1, name, spy)
    return calls


def _model(cfg_json, params):
    cfg = PipelineConfig.from_json(cfg_json)
    return bridge.load_params(build_model(cfg, device="cpu"), params)


def mesh_rank(rank, world, cfg_json, params, batch, shape):
    """On a ``shape`` mesh: the raw loss and gradients of the mesh step,
    the mesh eval loss, then one mesh train step; with the recurrence
    wrappers' call counts."""
    model = _model(cfg_json, params)
    mesh = make_mesh(MeshConfig(*shape), device="cpu")
    calls = _spy()
    loss, grads = step_lib.mesh_loss_and_grads(
        model, mesh, dict(model.named_parameters()), batch, None)
    grads = _numpy(grads)
    ev = float(step_lib.make_eval_step(model, mesh=mesh)(batch))
    state = step_lib.create_train_state(model)
    state, m = step_lib.make_train_step(model, mesh=mesh)(state, batch, None, 1.0)
    return {"loss": float(loss), "grads": grads, "eval": ev,
            "step_loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _numpy(state.params), "calls": dict(calls)}


def fit_rank(rank, world, cfg_json, params, corpus, workdir, epochs):
    """``fit`` over a DATAx1 mesh: the history, the final parameters and
    how many checkpoint files this rank wrote."""
    model = _model(cfg_json, params)
    mesh = make_mesh(MeshConfig(world, 1), device="cpu")
    writes = []
    for name in ("save_train_state", "save_fit_meta", "save_config"):
        real = getattr(ckpt_lib, name)

        def spy(*a, _real=real, _name=name, **kw):
            writes.append(_name)
            return _real(*a, **kw)

        setattr(ckpt_lib, name, spy)
    feats, labels, lab_len, in_len, ids, train_ids, val_ids = corpus
    data = Batcher(feats, labels, lab_len, in_len, ids, train_ids=train_ids, val_ids=val_ids)
    res = loop_lib.fit(model, data, workdir=workdir, epochs=epochs, mesh=mesh)
    return {"history": [{k: h[k] for k in ("train_loss", "val_loss", "grad_norm")}
                        for h in res.history],
            "params": _numpy(dict(model.named_parameters())),
            "writes": writes, "step": res.state.step}


def collectives_rank(rank, world):
    """The generic collectives on rank-specific shards: ``all_gather`` of
    this rank's slice of arange(2 * world) (tiled and stacked),
    ``reduce_scatter`` of ones(4 * world), and ``ppermute_ring`` of
    [rank] by shifts 1, -1 and 2."""
    g = dist.group.WORLD
    x = torch.arange(2.0 * rank, 2.0 * rank + 2)
    return {
        "all_gather": collectives.all_gather(x, g).numpy(),
        "all_gather_stacked": collectives.all_gather(x, g, tiled=False).numpy(),
        "reduce_scatter": collectives.reduce_scatter(torch.ones(4 * world), g).numpy(),
        "ring": [collectives.ppermute_ring(torch.tensor([float(rank)]), g, shift).numpy()
                 for shift in (1, -1, 2)],
    }


def barrier_rank(rank, world, fail_rank):
    """Rank ``fail_rank`` raises; the others wait at a barrier."""
    if rank == fail_rank:
        raise ValueError("rank failed on purpose")
    dist.barrier()
    return rank


def sleep_rank(rank, world, seconds):
    """A rank that hangs."""
    import time

    time.sleep(seconds)


def _small_skeletal():
    """The skeletal preset (noise and dropout on) at test size."""
    return tconfig.skeletal().replace(
        maxlen=40, encoder=tconfig.EncoderConfig(hidden=8, depth=2, input_noise=0.5,
                                                 dropout=(0.6, 0.6), output_dropout=0.6))


if __name__ == "__main__":
    # The port's CLI with the skeletal preset at test size, as torchrun
    # starts it in each rank.
    from mgr_tpu_torch.cli import main as cli

    tconfig.PRESETS["skeletal"] = _small_skeletal
    sys.exit(cli.main(sys.argv[1:]))
