"""Entry points: the flagship forward pass and a self-checking multi-rank
train step, as ``__graft_entry__.py`` has them for the JAX package.

``entry()`` (``__graft_entry__.py:16-32``) returns ``(fn, example_args)``:
the speech BLSTM model at the preset's full width with seeded random
weights, and a zero batch of B=8 utterances of T=1900 frames.
``fn(*example_args)`` gives (B, T, 44) logits.

``dryrun_multichip(n)`` (``__graft_entry__.py:67-412``) runs a train step
over a mesh of ``n`` ranks at tiny shapes in five phases, each held to
one process, and prints one ``ok`` line.

Both run on ``device``: ``cuda`` (the default, through the kernels; fails
without a card) or ``cpu`` (the plain versions), never on the CPU unless
asked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.config import EncoderConfig, MeshConfig, PipelineConfig, get_preset
from mgr_tpu_torch.models.zoo import build_model
from mgr_tpu_torch.ops import dispatch
from mgr_tpu_torch.parallel import sharding
from mgr_tpu_torch.parallel.mesh import make_mesh
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import step as step_lib

DRYRUN_TIMEOUT_S = 600.0  # ranks started to ranks joined
TOL_LOSS_REL = 1e-4       # mesh step's loss against one process's (JAX's)
TOL_CHECKSUM_REL = 1e-5   # sum of |parameters| after the step (JAX's)


def entry(device: str = "cuda"):
    cfg = get_preset("speech")
    model = build_model(cfg, device=device)  # raises without a card unless device="cpu"
    x = torch.zeros((8, cfg.maxlen, cfg.num_feats), dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(x):
        return model(x)

    return fn, (x,)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """One train step over meshes of ``n_devices`` ranks at tiny shapes
    (maxlen 32, 5 features, 6 classes, hidden 8 per model rank, f32),
    each phase checked against one process, as JAX's is:

    1. the phase-1 mesh (data x model x time as JAX picks it: 2 x 2 x 2
       blocks of 8 ranks, else data x 2 for an even count, else data
       only) with noise and dropout on: the loss is finite, and where the
       model axis exceeds 1 the rank computed only its part of every BLSTM
       (the gradient of each BLSTM leaf before the ranks combine it is
       zero outside its part), the counterpart of JAX's check that ``W``
       is sharded. JAX jits this step without ``mesh=`` and XLA
       partitions it; here the mesh's own route runs it
       (``parallel.sharding.shardmap_axes``): at n=8 the 2x2x2 mesh takes
       the GSPMD route (each model rank an H-block, a time axis of 2), at
       n=2 the 1x2x1 mesh the direction-sharded route (each model rank one
       direction, K5a/K5b on the card);
    2. pure data parallelism over every rank, noise and dropout off
       (phases 2-5): loss within ``TOL_LOSS_REL`` and the parameters'
       checksum within ``TOL_CHECKSUM_REL`` of one process's step on the
       same rows;
    3. (an even count) data x a model axis of 2, direction-sharded: the
       same checks;
    4. the mesh decode of phase 2's batch with its stepped parameters,
       equal to one process's decode bit for bit, in row order;
    5. late fusion over frozen speech and skeletal encoders on the data
       mesh: the encoders bit-unchanged, the fusion layer and head moved,
       and the checks of phase 2.

    Ranks are processes (``parallel.spawn.run_ranks``, gloo); on ``cuda``
    rank r runs on ``cuda:{r % device_count}`` (ranks time-share a card
    when there are fewer cards than ranks), on ``cpu`` the plain versions
    run. Each rank also runs the one-process reference after drawing its
    weights with one CPU thread, as the mesh model's. Any rank's failed
    check fails the run; rank 0's line is printed and its numbers (each
    phase's losses, errors and kernel launches) returned."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"dryrun_multichip(device={device!r}): no CUDA device on this "
                               f"host; pass device='cpu' for the plain versions")
        from mgr_tpu_torch.kernels import build

        build.load_all(sorted(set(dispatch.SOURCES.values())))  # the ranks load, never build
    result = run_ranks(_dryrun_rank, n_devices, (dev.type,), timeout_s=DRYRUN_TIMEOUT_S)[0]
    print(result["line"], flush=True)
    return result


def _mesh_shape(n: int):
    """JAX's phase-1 mesh: dp x tp x sp (``__graft_entry__.py:82-93``)."""
    if n % 8 == 0:
        return n // 4, 2, 2
    if n % 2 == 0:
        return n // 2, 2, 1
    return n, 1, 1


def _batch(cfg: PipelineConfig, B: int, feats2: int = 0) -> Dict[str, torch.Tensor]:
    """JAX's dryrun batch: every frame ones, labels [1, 2], lengths maxlen - 2."""
    batch = {
        "inputs": torch.ones((B, cfg.maxlen, cfg.num_feats)),
        "labels": torch.tensor([[1, 2, -1, -1]], dtype=torch.int32).repeat(B, 1),
        "input_length": torch.full((B,), cfg.maxlen - 2, dtype=torch.int32),
        "label_length": torch.full((B,), 2, dtype=torch.int32),
    }
    if feats2:
        batch["inputs2"] = torch.ones((B, cfg.maxlen, feats2))
    return batch


def _checksum(model: torch.nn.Module) -> float:
    return float(sum(p.detach().abs().float().sum() for p in model.parameters()))


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _one_process_step(cfg: PipelineConfig, batch, key, device,
                      sources: Optional[Dict[str, PipelineConfig]] = None):
    """One process's train step on ``batch`` from the same seeded weights:
    (loss, parameter checksum)."""
    model = build_model(cfg, sources, seed=0, device=device)
    state = step_lib.create_train_state(model)
    _, metrics = step_lib.make_train_step(model)(state, batch, key, 1.0)
    return float(metrics["loss"]), _checksum(model)


def _against_one_process(what: str, model, loss: float, cfg, batch, key, device,
                         sources=None) -> Dict[str, float]:
    """The mesh step's loss and checksum against one process's; JAX's
    messages."""
    _check(bool(np.isfinite(loss)), f"non-finite {what} loss {loss}")
    loss_1, csum_1 = _one_process_step(cfg, batch, key, device, sources)
    csum = _checksum(model)
    d_loss = abs(loss - loss_1)
    d_csum = abs(csum - csum_1) / max(abs(csum_1), 1.0)
    _check(d_loss < TOL_LOSS_REL * max(1.0, abs(loss_1)),
           f"{what} loss diverges from single device: {loss} vs {loss_1}")
    _check(d_csum < TOL_CHECKSUM_REL,
           f"{what} post-step params diverge: checksum {csum} vs {csum_1}")
    return {"loss": loss, "loss_1": loss_1, "dloss": d_loss, "dparams": d_csum}


def _check_split(grads: Dict[str, torch.Tensor], mesh, rank: int) -> int:
    """Every BLSTM leaf's gradient of this rank, before the ranks combine
    it, is zero outside the part this rank computes and not zero inside:
    its direction's slot on the direction-sharded route, its block of the
    hidden units on the GSPMD route. Returns the number of leaves
    checked."""
    gspmd = sharding.shardmap_axes(mesh.config) is None
    pspecs = sharding.param_pspecs(grads, mesh.config)
    checked = 0
    for name, g in grads.items():
        leaf = name.split(".")[-1]
        if not ((leaf in ("W", "U") and g.ndim == 4) or (leaf == "b" and g.ndim == 3)):
            continue
        if gspmd:
            _check(pspecs[name] is not None, f"rank {rank}: {name} is not H-sharded")
            parts = g.reshape(*g.shape[:-1], mesh.model, -1).movedim(-2, 0)
        else:
            parts = g  # (2, ...): one slot a direction
        own = mesh.model_index
        _check(bool(parts[own].any()) and not any(
            bool(parts[i].any()) for i in range(parts.shape[0]) if i != own),
            f"the model axis did not split {name} on rank {rank}: gradient outside "
            f"its {'H-block' if gspmd else 'direction'} {own}")
        checked += 1
    _check(checked > 0, f"rank {rank}: no BLSTM leaf to check")
    return checked


def _dryrun_rank(rank: int, world: int, device_type: str) -> Dict:
    """One rank of :func:`dryrun_multichip`; rank 0's result holds the line."""
    dev = (torch.device("cuda", rank % torch.cuda.device_count()) if device_type == "cuda"
           else torch.device("cpu"))
    data_par, model_par, time_par = _mesh_shape(world)
    enc = EncoderConfig(hidden=8 * model_par, depth=2, input_noise=0.1,
                        dropout=(0.1, 0.1), output_dropout=0.1)
    cfg = get_preset("speech").replace(
        maxlen=32, num_feats=5, nb_classes=6, max_label_len=4, batch_size=2 * data_par,
        encoder=enc, mesh=MeshConfig(data=data_par, model=model_par, time=time_par),
        compute_dtype="float32")
    launches = {}

    # Phase 1: the dp x tp x sp step, noise and dropout on.
    mesh = make_mesh(cfg.mesh, device=dev)
    model = build_model(cfg, seed=0, device=dev)
    batch = _batch(cfg, cfg.batch_size)
    split = 0
    if model_par > 1:
        _, grads = step_lib.rank_loss_and_grads(
            model, mesh, dict(model.named_parameters()), batch, prng.root_key(0))
        split = _check_split(grads, mesh, rank)
        del grads
    dispatch.reset_launch_counts()
    state = step_lib.create_train_state(model)
    _, metrics = step_lib.make_train_step(model, mesh=mesh)(state, batch, prng.root_key(0), 1.0)
    loss = float(metrics["loss"])
    launches["1"] = dispatch.launch_counts()
    _check(bool(np.isfinite(loss)), f"non-finite loss {loss}")

    # Phase 2: pure DP, noise and dropout off (phases 2-5): the shard_map
    # route folds the draws by data index, so one process agrees only
    # without them.
    enc_det = EncoderConfig(hidden=enc.hidden, depth=2, input_noise=0.0,
                            dropout=(0.0, 0.0), output_dropout=0.0)
    cfg_dp = cfg.replace(batch_size=2 * world, encoder=enc_det,
                         mesh=MeshConfig(data=world, model=1, time=1))
    mesh_dp = make_mesh(cfg_dp.mesh, device=dev)
    model_dp = build_model(cfg_dp, seed=0, device=dev)
    batch_dp = _batch(cfg_dp, cfg_dp.batch_size)
    dispatch.reset_launch_counts()
    state_dp = step_lib.create_train_state(model_dp)
    _, m_dp = step_lib.make_train_step(model_dp, mesh=mesh_dp)(
        state_dp, batch_dp, prng.root_key(1), 1.0)
    loss_dp = float(m_dp["loss"])
    launches["2"] = dispatch.launch_counts()
    dp = _against_one_process("DP shard_map", model_dp, loss_dp, cfg_dp, batch_dp,
                              prng.root_key(1), dev)

    # Phase 3: dp x tp2, each model rank one BLSTM direction.
    tp = None
    if world % 2 == 0:
        cfg_tp = cfg.replace(batch_size=world, encoder=enc_det,
                             mesh=MeshConfig(data=world // 2, model=2, time=1))
        mesh_tp = make_mesh(cfg_tp.mesh, device=dev)
        model_tp = build_model(cfg_tp, seed=0, device=dev)
        batch_tp = _batch(cfg_tp, cfg_tp.batch_size)
        dispatch.reset_launch_counts()
        state_tp = step_lib.create_train_state(model_tp)
        _, m_tp = step_lib.make_train_step(model_tp, mesh=mesh_tp)(
            state_tp, batch_tp, prng.root_key(2), 1.0)
        loss_tp = float(m_tp["loss"])
        launches["3"] = dispatch.launch_counts()
        tp = _against_one_process("direction-TP", model_tp, loss_tp, cfg_tp, batch_tp,
                                  prng.root_key(2), dev)
        del model_tp, state_tp

    # Phase 4: the mesh decode of phase 2's rows with its stepped weights.
    dispatch.reset_launch_counts()
    best, emit = step_lib.make_decode_step(model_dp, threshold=0.0, trim_frames=2, mesh=mesh_dp)(
        batch_dp["inputs"], batch_dp["input_length"])
    launches["4"] = dispatch.launch_counts()
    n_emitted = int(emit.sum())
    _check(best.shape[0] == cfg_dp.batch_size, f"{tuple(best.shape)}")
    best_1, emit_1 = step_lib.make_decode_step(model_dp, threshold=0.0, trim_frames=2)(
        batch_dp["inputs"], batch_dp["input_length"])
    n_best = int((best.cpu() != best_1.cpu()).sum())
    n_emit = int((emit.cpu() != emit_1.cpu()).sum())
    _check(n_best == 0 and n_emit == 0,
           f"mesh decode diverges from single device: {n_best} argmax / {n_emit} emit "
           f"mismatches")
    del model_dp, state_dp

    # Phase 5: late fusion's frozen encoders on the data mesh.
    sources = {
        "speech": get_preset("speech").replace(
            maxlen=32, num_feats=5, nb_classes=6, encoder=enc_det, compute_dtype="float32"),
        "skeletal": get_preset("skeletal").replace(
            maxlen=32, num_feats=4, nb_classes=6, encoder=enc_det, compute_dtype="float32"),
    }
    lf = get_preset("late_fusion")
    cfg_lf = lf.replace(
        maxlen=32, nb_classes=6, max_label_len=4, batch_size=2 * world, fusion_hidden=8,
        fusion_dropout=0.0, fusion_output_dropout=0.0, second_stream_noise=0.0,
        encoder=dataclasses.replace(lf.encoder, input_noise=0.0), head_blank_bias=-3.0,
        mesh=MeshConfig(data=world, model=1, time=1), compute_dtype="float32")
    model_lf = build_model(cfg_lf, sources, seed=0, device=dev)
    params = dict(model_lf.named_parameters())
    encoders = {k: p.detach().clone() for k, p in params.items()
                if k.split(".")[0] in ("speech", "skeletal")}
    head_before = {k: p.detach().clone() for k, p in params.items() if k not in encoders}
    batch_lf = _batch(sources["speech"], 2 * world, feats2=sources["skeletal"].num_feats)
    dispatch.reset_launch_counts()
    state_lf = step_lib.create_train_state(model_lf)
    _, m_lf = step_lib.make_train_step(model_lf, mesh=mesh_dp)(
        state_lf, batch_lf, prng.root_key(3), 1.0)
    loss_lf = float(m_lf["loss"])
    launches["5"] = dispatch.launch_counts()
    _check(all(torch.equal(params[k], v) for k, v in encoders.items()),
           "frozen encoder params changed under shard_map DP")
    _check(any(not torch.equal(params[k], v) for k, v in head_before.items()),
           "fusion/head params did not update under the late-fusion DP step")
    late = _against_one_process("late-fusion DP", model_lf, loss_lf, cfg_lf, batch_lf,
                                prng.root_key(3), dev, sources)

    tp_text = ("not run (odd rank count)" if tp is None else
               f"loss={tp['loss']:.4f} (dloss={tp['dloss']:.2e}, dparams={tp['dparams']:.2e})")
    line = (f"dryrun_multichip({world}): ok, loss={loss:.4f}, "
            f"mesh=data:{data_par} x model:{model_par} x time:{time_par}; "
            f"dp-shard_map loss={dp['loss']:.4f} "
            f"(vs single-device {dp['loss_1']:.4f}, dloss={dp['dloss']:.2e}, "
            f"dparams={dp['dparams']:.2e}); "
            f"dp x tp2 direction-sharded {tp_text}; "
            f"dp decode emitted {n_emitted} frames (mesh==single-device exactly); "
            f"late_fusion frozen-encoder dp loss={late['loss']:.4f} "
            f"(dloss={late['dloss']:.2e}, dparams={late['dparams']:.2e}, encoders bit-frozen)")
    return {"line": line, "loss": loss, "split_leaves_checked": split, "dp": dp, "tp": tp,
            "decode_emitted": n_emitted, "late_fusion": late, "launches": launches,
            "device": str(dev)}
