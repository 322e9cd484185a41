"""Rank bodies of the gloo mesh tests in ``tests/test_torch_parallel.py``
and ``tests/test_torch_mesh_*.py``.

Each function runs in a process spawned by
``mgr_tpu_torch.parallel.spawn.run_ranks``, inside an initialized gloo
process group on the CPU. This module imports no JAX and nothing of the
JAX package, so that a rank starts fast; results go back as numpy arrays.
"""

import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import tracing
from mgr_tpu_torch.core.config import MeshConfig, PipelineConfig
from mgr_tpu_torch.data import datasets
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.parallel import collectives
from mgr_tpu_torch.parallel.mesh import make_mesh
from mgr_tpu_torch.train import curriculum as curriculum_lib
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


def _model(cfg_json, params, sources_json=None):
    """The model of a config (late fusion: over the source configs) on the
    CPU with the given JAX tree of weights."""
    cfg = PipelineConfig.from_json(cfg_json)
    sources = None if sources_json is None else {
        k: PipelineConfig.from_json(v) for k, v in sources_json.items()}
    return bridge.load_params(build_model(cfg, sources, device="cpu"), params)


def _digest(params) -> str:
    return hashlib.sha256(b"".join(v.detach().float().numpy().tobytes()
                                   for v in params.values())).hexdigest()


def families_rank(rank, world, shape, cases):
    """On a ``shape`` mesh, for each case (a family's config, weights and
    global batch): the raw loss and gradients of the mesh step, the mesh
    eval loss, then one mesh train step (its loss, the parameters and
    Adam's moments after it), with the recurrence wrappers' calls."""
    mesh = make_mesh(MeshConfig(*shape), device="cpu")
    calls = _spy()
    out = []
    for case in cases:
        model = _model(case["cfg"], case["params"], case.get("sources"))
        batch = case["batch"]
        before = dict(calls)
        loss, grads = step_lib.mesh_loss_and_grads(
            model, mesh, dict(model.named_parameters()), batch, None)
        grads = _numpy(grads)
        ev = float(step_lib.make_eval_step(model, mesh=mesh)(batch))
        state = step_lib.create_train_state(model)
        state, m = step_lib.make_train_step(model, mesh=mesh)(state, batch, None, 1.0)
        out.append({"loss": float(loss), "grads": grads, "eval": ev,
                    "step_loss": float(m["loss"]), "params": _numpy(state.params),
                    "mu": _numpy(state.opt_state.mu), "nu": _numpy(state.opt_state.nu),
                    "calls": {k: calls[k] - before[k] for k in calls}})
    return out


def decode_rank(rank, world, shape, cases):
    """On a ``shape`` mesh, for each case: the mesh decode step's (best,
    emit) of the global batch, without and with the input lengths."""
    mesh = make_mesh(MeshConfig(*shape), device="cpu")
    out = []
    for case in cases:
        model = _model(case["cfg"], case["params"], case.get("sources"))
        step = step_lib.make_decode_step(model, threshold=case["threshold"], mesh=mesh)
        inputs = step_lib.batch_inputs(case["batch"])
        out.append([tuple(t.numpy() for t in step(inputs, lengths))
                    for lengths in (None, case["batch"]["input_length"])])
    return out


def fit_families_rank(rank, world, shape, cases, workdir):
    """``fit`` over a ``shape`` mesh for each case: an array corpus (two
    streams) or a lazy video corpus (``LazyVideoBatcher``), with its data
    path; the history and a digest of the final parameters."""
    mesh = make_mesh(MeshConfig(*shape), device="cpu")
    out = []
    for case in cases:
        model = _model(case["cfg"], case["params"])
        cfg = model.config
        if "videos" in case:
            data = datasets.build_rgb_dataset(*case["videos"], cfg)
        else:
            data = Batcher(*case["corpus"])
        res = loop_lib.fit(model, data, workdir=f"{workdir}/{case['tag']}", epochs=2,
                           mesh=mesh, device_data=case.get("device_data"))
        out.append({"history": [{k: h[k] for k in ("train_loss", "val_loss")}
                                for h in res.history],
                    "digest": _digest(dict(model.named_parameters())),
                    "step": res.state.step})
    return out


def _write_spy():
    """The stamps of the slots this rank writes."""
    writes = []
    real = ckpt_lib.save_train_state

    def spy(workdir, stamp, *a, **kw):
        writes.append(stamp)
        return real(workdir, stamp, *a, **kw)

    ckpt_lib.save_train_state = spy
    return writes


def curriculum_rank(rank, world, cfgs_json, corpus, workdir, shape=None):
    """``run_curriculum`` over a ``shape`` mesh (by default DATAx1) on the
    corpus's files: the stamps of the slots this rank wrote, each stage's
    history and a digest of its final parameters."""
    cfgs = {k: PipelineConfig.from_json(v) for k, v in cfgs_json.items()}
    mesh = make_mesh(MeshConfig(*(shape or (world, 1))), device="cpu")
    writes = _write_spy()
    speech = datasets.build_audio_dataset(corpus["audio_dir"], corpus["audio_labels"],
                                          cfgs["speech"])
    skeletal = datasets.build_skeletal_dataset(corpus["sk_csv"], corpus["labels"],
                                               cfgs["skeletal"])
    fusion = datasets.build_late_fusion_dataset(corpus["audio_dir"], corpus["sk_csv"],
                                                corpus["labels"], cfgs["late_fusion"])
    res = curriculum_lib.run_curriculum(speech, skeletal, fusion, workdir, configs=cfgs,
                                        mesh=mesh, epochs=2)
    return {"writes": sorted(set(writes)),
            "stages": {k: {"history": [{h_k: h[h_k] for h_k in ("train_loss", "val_loss")}
                                       for h in r.history],
                           "digest": _digest(r.state.params)} for k, r in res.items()}}


def nan_rank(rank, world, cfg_json, params, batch, model_axis=1, nan_dz=False):
    """A mesh train step under ``debug_nans`` on a mesh of ``world //
    model_axis`` x ``model_axis`` ranks, on a batch whose NaN (if any) lies
    in rank 0's rows; with ``nan_dz`` rank 0 alone makes a NaN in the
    backward of direction 0's recurrence (its dz), the forward finite.
    Returns what each rank raised, after how many seconds, and whether
    anomaly mode is off once ``debug_nans`` is switched off."""
    model = _model(cfg_json, params)
    mesh = make_mesh(MeshConfig(world // model_axis, model_axis), device="cpu")
    if nan_dz and rank == 0:
        plain = tlstm.lstm_scan_tm_bwd_plain

        def nan_in_direction_0(xp, U1, hs, cs, dhs, *, reverse):
            dz, dU = plain(xp, U1, hs, cs, dhs, reverse=reverse)
            return (dz if reverse else torch.full_like(dz, float("nan"))), dU

        tlstm.lstm_scan_tm_bwd_plain = nan_in_direction_0
    step = step_lib.make_train_step(model, mesh=mesh)
    tracing.debug_nans(True)
    t0 = time.monotonic()
    try:
        step(step_lib.create_train_state(model), batch, None, 1.0)
        raised = None
    except FloatingPointError as err:
        raised = f"FloatingPointError: {err}"
    finally:
        tracing.debug_nans(False)
    return {"raised": raised, "seconds": time.monotonic() - t0,
            "anomaly_after": torch.is_anomaly_enabled()}


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


def replay_draws(draws):
    """Route ``prng.bernoulli`` and ``prng.normal`` to recorded draws:
    ``draws`` maps (kind, seed, path, shape) to the array drawn there (in
    the tests JAX's, on the same fold path). Returns a function that puts
    the port's own draws back."""
    real = prng.bernoulli, prng.normal

    def look(kind, key, shape):
        return torch.from_numpy(draws[kind, key.seed, key.path, tuple(shape)].copy())

    prng.bernoulli = lambda key, p, shape, device="cpu": look("bernoulli", key, shape)
    prng.normal = lambda key, shape, dtype, device="cpu": look("normal", key, shape).to(dtype)

    def restore():
        prng.bernoulli, prng.normal = real

    return restore


def _count_all_reduces():
    """Count every ``torch.distributed.all_reduce`` of this rank (the
    exchanges, the time gathers, their transposes and the combination of
    the gradients): a one-element list."""
    count, real = [0], dist.all_reduce

    def spy(*a, **kw):
        count[0] += 1
        return real(*a, **kw)

    dist.all_reduce = spy
    return count


def _gspmd_step(model, mesh, batch, key, calls, reduces):
    """The raw loss and gradients of the mesh step with the calls and
    all-reduces they made, the mesh eval loss, then one mesh train step."""
    trainable = model.trainable()
    frozen = {k: p.detach().clone() for k, p in model.named_parameters() if not trainable[k]}
    before, n0 = dict(calls), reduces[0]
    loss, grads = step_lib.mesh_loss_and_grads(model, mesh, dict(model.named_parameters()),
                                               batch, key)
    grads = _numpy(grads)
    r = {"loss": float(loss), "grads": grads, "all_reduces": reduces[0] - n0,
         "calls": {k: calls[k] - before[k] for k in calls}}
    r["eval"] = float(step_lib.make_eval_step(model, mesh=mesh)(batch))
    state = step_lib.create_train_state(model)
    state, m = step_lib.make_train_step(model, mesh=mesh)(state, batch, key, 1.0)
    r.update(step_loss=float(m["loss"]), params=_numpy(state.params),
             frozen=sorted(frozen), frozen_unchanged=all(
                 torch.equal(p, frozen[k]) for k, p in model.named_parameters() if k in frozen))
    return r


def _nan_step(rank, model, mesh, batch, key, nan_dz):
    """One mesh train step under ``debug_nans`` with the port's draws from
    ``key``; with ``nan_dz`` rank 0 alone makes a NaN in the backward of the
    H-sharded recurrence (its dz), its forward finite. What this rank
    raised, and after how long."""
    real = tlstm.hard_sigmoid_grad
    if nan_dz and rank == 0:
        tlstm.hard_sigmoid_grad = lambda z: torch.full_like(z, float("nan"))
    tracing.debug_nans(True)
    t0 = time.monotonic()
    try:
        step_lib.make_train_step(model, mesh=mesh)(step_lib.create_train_state(model), batch,
                                                   key, 1.0)
        raised = None
    except FloatingPointError as err:
        raised = f"FloatingPointError: {err}"
    finally:
        tracing.debug_nans(False)
        tlstm.hard_sigmoid_grad = real
    return {"raised": raised, "seconds": time.monotonic() - t0}


def gspmd_rank(rank, world, shape, cases, nans=(), fit=None):
    """On a ``shape`` (data, model, time) mesh of the GSPMD route, for each
    case (a family's config, weights, global batch, the key of its draws
    as (seed, path) or None, and ``draws`` to replay or None):
    :func:`_gspmd_step`, its calls counting the H-sharded scans beside the
    recurrence wrappers. Then each of ``nans`` (a config, weights, a batch,
    a key and ``nan_dz``) under ``debug_nans``, and with ``fit`` (a config,
    weights, a corpus and a workdir) ``fit`` for 2 epochs over the mesh,
    then resumed to 3: the histories, a digest of the final parameters and
    the slot writes of this rank."""
    mesh = make_mesh(MeshConfig(*shape), device="cpu")
    calls = _spy()
    calls["hsharded_steps"], real_steps = 0, tlstm._hsharded_steps

    def steps(*a, **kw):
        calls["hsharded_steps"] += 1
        return real_steps(*a, **kw)

    tlstm._hsharded_steps = steps
    reduces = _count_all_reduces()
    out = {"steps": [], "nans": [], "fit": None}
    for case in cases:
        restore = replay_draws(case["draws"]) if case["draws"] else (lambda: None)
        try:
            model = _model(case["cfg"], case["params"], case.get("sources"))
            key = None if case["key"] is None else prng.Key(*case["key"])
            r = _gspmd_step(model, mesh, case["batch"], key, calls, reduces)
        finally:
            restore()
        out["steps"].append(r)
    for case in nans:
        model = _model(case["cfg"], case["params"])
        out["nans"].append(_nan_step(rank, model, mesh, case["batch"], prng.Key(*case["key"]),
                                     case["nan_dz"]))
    if fit is not None:
        writes = _write_spy()
        model = _model(fit["cfg"], fit["params"])
        data = Batcher(*fit["corpus"][:5], train_ids=fit["corpus"][5], val_ids=fit["corpus"][6])
        first = loop_lib.fit(model, data, workdir=fit["workdir"], epochs=2, mesh=mesh)
        resumed = loop_lib.fit(_model(fit["cfg"], fit["params"]), data, workdir=fit["workdir"],
                               epochs=3, resume=True, mesh=mesh)
        out["fit"] = {"history": [[h[k] for k in ("train_loss", "val_loss")]
                                  for h in first.history + resumed.history],
                      "digest": _digest(resumed.state.params), "writes": sorted(set(writes)),
                      "step": resumed.state.step}
    return out


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


def _small(name, **kw):
    """Another family's preset at test size: T=24, BiLSTM(8)x2 (rgb: T=6
    and a narrow CNN on 44x44 frames), its noise and dropout kept."""
    cfg = _PRESETS[name]()
    enc = tconfig.EncoderConfig(hidden=8, depth=2, input_noise=cfg.encoder.input_noise,
                                dropout=cfg.encoder.dropout,
                                output_dropout=cfg.encoder.output_dropout)
    return cfg.replace(**{"maxlen": 24, "encoder": enc, **kw})


_PRESETS = dict(tconfig.PRESETS)  # the full-size presets, before __main__ patches them
SMALL_PRESETS = {
    "skeletal": _small_skeletal,
    "speech": lambda: _small("speech", max_label_len=12),
    "early_fusion": lambda: _small("early_fusion", max_label_len=4),
    "late_fusion": lambda: _small("late_fusion", max_label_len=4, fusion_hidden=4),
    "rgb": lambda: _small("rgb", maxlen=6, max_label_len=3,
                          cnn=tconfig.CNNConfig(img_dim=44, channels=(4, 6, 8))),
}


def dryrun_perturbed_rank(rank, world, device_type):
    """A rank of ``entry.dryrun_multichip`` whose one-process reference is
    handed perturbed rows (row 0's inputs doubled): the run's self-check
    must fail it."""
    from mgr_tpu_torch import entry

    real = entry._one_process_step

    def perturbed(cfg, batch, key, device, sources=None):
        batch = dict(batch)
        batch["inputs"] = batch["inputs"].clone()
        batch["inputs"][0] *= 2.0
        return real(cfg, batch, key, device, sources)

    entry._one_process_step = perturbed
    return entry._dryrun_rank(rank, world, device_type)


if __name__ == "__main__":
    # The port's CLI with every preset at test size, as torchrun starts it
    # in each rank.
    from mgr_tpu_torch.cli import main as cli

    tconfig.PRESETS.update(SMALL_PRESETS)
    sys.exit(cli.main(sys.argv[1:]))
