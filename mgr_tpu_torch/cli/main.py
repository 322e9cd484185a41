"""CLI of the port: the train, curriculum and serving commands of
``mgr_tpu/cli/main.py`` (``:101-344``), with the same flags, for the five
families: speech, skeletal, rgb, early fusion and late fusion; and the
data-preparation commands (``:347-391``): ``prepare-audio``,
``prepare-skeletal``, ``prepare-rgb`` (featurizers on ``--device``) and
``mix`` (host only).

    python -m mgr_tpu_torch.cli.main train speech --data-dir ... --labels ... --workdir runs
    python -m mgr_tpu_torch.cli.main train rgb --data-dir <Sample#####_color.npy dir> --labels ...
    python -m mgr_tpu_torch.cli.main train early_fusion --audio-csv ... --skeletal-csv ...
    python -m mgr_tpu_torch.cli.main train late_fusion --audio-dir ... --skeletal-csv ... --labels ...
    python -m mgr_tpu_torch.cli.main curriculum --audio-dir ... --audio-labels ... \
        --skeletal-csv ... --labels ... --workdir runs
    python -m mgr_tpu_torch.cli.main infer speech utt.csv --workdir runs
    python -m mgr_tpu_torch.cli.main infer rgb Sample00001_color.npy --workdir runs
    python -m mgr_tpu_torch.cli.main decode speech --workdir runs --data-dir ... --labels ...
    python -m mgr_tpu_torch.cli.main evaluate speech --workdir runs --data-dir ... --labels ...
    python -m mgr_tpu_torch.cli.main score refs.mlf hyps.mlf
    python -m mgr_tpu_torch.cli.main prepare-audio --wav-dir wavs --out-dir audio
    python -m mgr_tpu_torch.cli.main prepare-skeletal --raw-dir kinect --out-csv train.csv \
        --val-csv val.csv --split-at 403
    python -m mgr_tpu_torch.cli.main prepare-rgb --video-dir videos --skeletal-dir kinect \
        --out-dir rois
    python -m mgr_tpu_torch.cli.main mix --audio-train ... --audio-val ... --skeletal-train ... \
        --skeletal-val ... --train-labels ... --val-labels ... --out-root mixed
    python -m mgr_tpu_torch.cli.main bench [--pipeline speech] [--batch B] [--latency]

A workdir holds ``<pipeline>_config.json`` and the slots
(``mgr_tpu_torch.core.checkpoint``); ``train`` writes them. A workdir the
JAX package wrote (its config plus ``<pipeline>_<slot>.msgpack`` slots)
serves as it is: ``decode``, ``evaluate``, ``infer``, ``train --resume``
and the late-fusion graft read the msgpack slots where the port has no
``.pt`` of its own. ``train late_fusion`` grafts the best speech and
skeletal slots of its workdir into the fusion model's frozen encoders
(unless ``--from-scratch``), and ``decode``/``evaluate late_fusion``
build the model through that graft, as the JAX CLI does; ``curriculum``
trains the three stages in one workdir. The rgb commands read a directory
of per-video frames (``--data-dir``), normalised as ``(x - 128) / 255``,
as ``infer rgb`` normalises its one video. The model (or a ``prepare-*``
command's featurizer) runs on ``--device``:
``cuda`` (the default: the first card, through the kernels) or ``cpu``
(through their plain versions), and a command asked for ``cuda`` on a
host without a card fails; it never carries on on the CPU.

``train`` (and ``curriculum``, which ignores them as the JAX one does)
takes the JAX CLI's ``--trace-dir`` (a ``torch.profiler``
trace of the run), ``--debug-nans`` (the steps raise
``FloatingPointError`` on a non-finite loss or gradient norm; autograd's
anomaly mode on), ``--async-checkpoints`` (slots written by a background
thread) and ``--cache-dir`` (the speech corpus kept as one ``.npz``, the
JAX package's cache format).

``train --mesh DATAxMODEL[xTIME]`` trains any family over a mesh of
ranks, one process per rank, started by torchrun: pure data parallelism,
data parallelism x direction-sharded tensor parallelism with MODEL = 2,
or the GSPMD route (MODEL above 2: each rank computes a block of the
LSTMs' hidden units, one exchange a time step; TIME above 1: each rank
projects a slice of the time steps); ``curriculum --mesh`` trains its
three stages over it:

    torchrun --nproc-per-node 4 -m mgr_tpu_torch.cli.main train early_fusion --mesh 2x2 ...
    torchrun --nproc-per-node 2 -m mgr_tpu_torch.cli.main curriculum --mesh 2x1 ...
    torchrun --nproc-per-node 4 -m mgr_tpu_torch.cli.main train speech --mesh 1x4 ...
    torchrun --nproc-per-node 4 -m mgr_tpu_torch.cli.main train speech --mesh 1x2x2 ...

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL, or with ``--device cpu``
on the CPU over gloo; rank 0 writes the workdir and prints the result.
``--debug-nans`` on a mesh makes every rank raise at the same step.
``decode`` decodes over the mesh stored in the workdir's config when it is
started with that many processes (torchrun sets ``WORLD_SIZE``), else in
one process, as the JAX CLI decodes without a mesh on a host that lacks
the devices; rank 0 writes the MLF (a stored mesh of the GSPMD route
decodes with the one-process step on every rank, as JAX's does).
``evaluate`` runs in one process, as in JAX.

``bench`` is ``python -m mgr_tpu_torch.bench`` (``mgr_tpu_torch/bench.py``)
with the same flags: one JSON line of one pipeline's train and decode
throughput, or with ``--latency`` its B=1 decode latency, on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from mgr_tpu_torch import bench

PIPELINES = ["speech", "skeletal", "rgb", "early_fusion", "late_fusion"]
FUSION = ("early_fusion", "late_fusion")


def _device(args):
    """The device ``--device`` names; a CUDA device must exist."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device on this host (pass "
            f"--device cpu to run the plain versions on the CPU)")
    return torch.device("cuda", 0) if dev == torch.device("cuda") else dev


def _load_model(args, dev=None):
    """The workdir's config and its ``--slot`` parameters in the model, on
    ``dev`` (default ``--device``); late fusion built through the graft of
    the workdir's encoders, as the JAX CLI builds it
    (``mgr_tpu/cli/main.py:213-216``)."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained

    cfg = ckpt_lib.load_config(args.workdir, args.pipeline)
    dev = dev or _device(args)
    if args.pipeline == "late_fusion":
        model = build_fusion_with_pretrained(args.workdir, cfg, device=dev)
    else:
        model = build_model(cfg, device=dev)
    return cfg, ckpt_lib.load_params(args.workdir, args.pipeline, model, slot=args.slot)


def _config_for(args, name: str):
    """The preset with the command line's overrides
    (``mgr_tpu/cli/main.py:60-90``, without the mesh)."""
    import dataclasses

    from mgr_tpu_torch.core import config as cfglib

    cfg = cfglib.get_preset(name)
    over = {}
    if args.batch_size:
        over["batch_size"] = args.batch_size
    if args.true_lengths:
        over["ctc"] = cfglib.CTCConfig(padded_length_parity=False)
    opt_over = {}
    if args.accum_steps is not None:
        if args.accum_steps < 1:
            raise SystemExit(f"--accum-steps must be >= 1, got {args.accum_steps}")
        opt_over["accum_steps"] = args.accum_steps
    if args.lr is not None:
        if args.lr <= 0:
            raise SystemExit(f"--lr must be > 0, got {args.lr}")
        opt_over["learning_rate"] = args.lr
    if opt_over:
        over["optimizer"] = dataclasses.replace(cfg.optimizer, **opt_over)
    if args.compute_dtype:
        over["compute_dtype"] = args.compute_dtype
    if args.mesh:
        parts = [int(x) for x in args.mesh.lower().split("x")]
        over["mesh"] = cfglib.MeshConfig(
            data=parts[0], model=parts[1] if len(parts) > 1 else 1,
            time=parts[2] if len(parts) > 2 else 1)
    return cfg.replace(**over) if over else cfg


def _mesh_for(cfg, dev):
    """The mesh of ``cfg.mesh`` over torchrun's process group, or None for
    a single process. Exits when the process count is not the mesh's."""
    import os

    from mgr_tpu_torch.parallel import mesh as mesh_lib
    from mgr_tpu_torch.parallel import multihost

    n = cfg.mesh.num_devices
    if n <= 1:
        return None
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != n:
        raise SystemExit(
            f"mesh {cfg.mesh.data}x{cfg.mesh.model}x{cfg.mesh.time} runs {n} processes, "
            f"one per rank: "
            f"launch it as `torchrun --nproc-per-node {n} -m mgr_tpu_torch.cli.main ...` "
            f"(WORLD_SIZE is {world})")
    multihost.initialize("nccl" if dev.type == "cuda" else "gloo")
    return mesh_lib.make_mesh(cfg.mesh, device=None if dev.type == "cuda" else dev)


def _close(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_train(args) -> int:
    from mgr_tpu_torch.core import tracing
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained
    from mgr_tpu_torch.train.loop import fit

    cfg = _config_for(args, args.pipeline)
    dev = _device(args)
    mesh = _mesh_for(cfg, dev)
    where = dev if mesh is None else mesh.device
    data = _build_dataset(args.pipeline, cfg, args, mode="train")
    if args.pipeline == "late_fusion" and not args.from_scratch:
        # The graft is the starting point; --resume then restores the
        # latest slot over it, as the JAX CLI's resume does.
        model = build_fusion_with_pretrained(args.workdir, cfg, device=where)
    else:
        model = build_model(cfg, device=where)
    if args.debug_nans:
        tracing.debug_nans(True)
    try:
        with tracing.trace(args.trace_dir):
            res = fit(model, data, workdir=args.workdir, resume=args.resume,
                      epochs=args.epochs, checkpoint_every=args.checkpoint_every,
                      monitor=args.monitor, mesh=mesh,
                      async_checkpoints=args.async_checkpoints)
    finally:
        if args.debug_nans:
            tracing.debug_nans(False)
    if mesh is None or mesh.is_primary:
        print(json.dumps({
            "pipeline": args.pipeline,
            "best_val_loss": res.best_val_loss,
            "epochs_run": res.epochs_run,
        }))
    _close(mesh)
    return 0


def cmd_curriculum(args) -> int:
    """speech -> skeletal -> late fusion in one workdir
    (``mgr_tpu/cli/main.py:173-200``). It takes every train flag and reads
    what the JAX command reads (the corpus, ``--workdir``, ``--epochs``,
    the config overrides and ``--mesh``, the speech config's mesh for all
    three stages); ``--resume``, ``--checkpoint-every``, ``--monitor``,
    ``--trace-dir``, ``--debug-nans``, ``--async-checkpoints`` and
    ``--cache-dir`` are accepted and ignored, as there."""
    from mgr_tpu_torch.data import datasets
    from mgr_tpu_torch.train.curriculum import run_curriculum

    cfgs = {name: _config_for(args, name) for name in ("speech", "skeletal", "late_fusion")}
    dev = _device(args)
    mesh = _mesh_for(cfgs["speech"], dev)
    speech = datasets.build_audio_dataset(args.audio_dir, args.audio_labels, cfgs["speech"])
    skeletal = datasets.build_skeletal_dataset(args.skeletal_csv, args.labels, cfgs["skeletal"])
    fusion = datasets.build_late_fusion_dataset(args.audio_dir, args.skeletal_csv, args.labels,
                                                cfgs["late_fusion"])
    results = run_curriculum(speech, skeletal, fusion, args.workdir, configs=cfgs,
                             mesh=mesh, epochs=args.epochs, device=dev)
    if mesh is None or mesh.is_primary:
        print(json.dumps({k: {"best_val_loss": v.best_val_loss, "epochs": v.epochs_run}
                          for k, v in results.items()}))
    _close(mesh)
    return 0


def _build_dataset(name: str, cfg, args, mode: str):
    from mgr_tpu_torch.data import datasets

    if name == "speech":
        return datasets.build_audio_dataset(args.data_dir, args.labels, cfg, mode=mode,
                                            cache_dir=getattr(args, "cache_dir", None))
    if name == "skeletal":
        return datasets.build_skeletal_dataset(args.skeletal_csv, args.labels, cfg, mode=mode)
    if name == "rgb":
        return datasets.build_rgb_dataset(args.data_dir, args.labels, cfg, mode=mode)
    if name == "early_fusion":
        return datasets.build_early_fusion_dataset(args.audio_csv, args.skeletal_csv, cfg,
                                                   mode=mode)
    if name == "late_fusion":
        return datasets.build_late_fusion_dataset(args.audio_dir, args.skeletal_csv,
                                                  args.labels, cfg, mode=mode)
    raise KeyError(name)


def _stored_mesh(args, dev):
    """The mesh of the workdir's config when this process is one of as
    many ranks (torchrun's ``WORLD_SIZE``), else None: decode then runs in
    one process, as the JAX CLI decodes without a mesh on a host that
    lacks the devices (``mgr_tpu/cli/main.py:248-256``)."""
    import os

    from mgr_tpu_torch.core import checkpoint as ckpt_lib

    cfg = ckpt_lib.load_config(args.workdir, args.pipeline)
    n = cfg.mesh.num_devices
    if n <= 1 or os.environ.get("WORLD_SIZE") != str(n):
        return None
    return _mesh_for(cfg, dev)


def cmd_decode(args) -> int:
    from mgr_tpu_torch.decode.decoder import DECODE_SPECS, MLF_FILENAMES, Decoder

    dev = _device(args)
    beam = args.beam and args.beam > 1
    mesh = None if beam else _stored_mesh(args, dev)
    cfg, model = _load_model(args, dev if mesh is None else mesh.device)
    data = _build_dataset(args.pipeline, cfg, args, mode=args.dataset)
    dec = Decoder.for_model(model, args.pipeline, mesh=mesh)
    if beam:
        from mgr_tpu_torch.decode.beam import beam_decode_batch
        from mgr_tpu_torch.train.step import batch_inputs, make_predict_step

        spec = DECODE_SPECS[args.pipeline]
        predict = make_predict_step(model)
        results = []
        for ids, batch in data.epoch(cfg.batch_size, train=False):
            probs = predict(batch_inputs(batch)).cpu().numpy()
            lengths = batch["input_length"] if args.true_lengths else None
            seqs = beam_decode_batch(probs, lengths, beam_width=args.beam,
                                     trim_frames=spec.trim_frames)
            results.extend((fid, [spec.vocab[i] for i in s]) for fid, s in zip(ids, seqs))
    else:
        results = dec.decode_batches(data.epoch(cfg.batch_size, train=False),
                                     use_lengths=args.true_lengths)
    out = args.out or MLF_FILENAMES[args.pipeline]
    if mesh is None or mesh.is_primary:
        dec.write_mlf(out, results)
        print(json.dumps({"decoded": len(results), "mlf": out}))
    _close(mesh)
    return 0


def cmd_infer(args) -> int:
    """One utterance file -> decoded tokens on stdout (the serving path)."""
    import numpy as np

    from mgr_tpu_torch.data import formats
    from mgr_tpu_torch.data.batcher import pad_or_truncate
    from mgr_tpu_torch.decode.decoder import Decoder

    cfg, model = _load_model(args)
    if args.pipeline == "speech":
        x = formats.load_audio_file_csv(args.input)
        if cfg.downsample > 1:
            x = x[:: cfg.downsample]
    elif args.pipeline == "skeletal":
        x = next(iter(formats.load_skeletal_csv(args.input, normalize=True).values()))
    elif args.pipeline == "rgb":
        x = (formats.load_video_npy(args.input) - 128.0) / 255.0
    else:
        raise SystemExit("infer supports speech/skeletal/rgb inputs")
    padded, true_len = pad_or_truncate(x.astype(np.float32), cfg.maxlen)
    batch = {
        "inputs": padded[None],
        "input_length": np.asarray([true_len - cfg.ctc.trim_frames], np.int32),
    }
    results = Decoder.for_model(model, args.pipeline).decode_batches(
        [((0,), batch)], use_lengths=args.true_lengths
    )
    print(json.dumps({"tokens": results[0][1]}))
    return 0


def cmd_score(args) -> int:
    from mgr_tpu_torch.decode.mlf import read_mlf
    from mgr_tpu_torch.decode.scorer import score_sequences

    refs, hyps = read_mlf(args.refs), read_mlf(args.hyps)
    print(json.dumps(score_sequences(refs, hyps, ignore_missing=args.partial)))
    return 0


def cmd_evaluate(args) -> int:
    """Decode a split and score it against the dataset's own labels."""
    from mgr_tpu_torch.decode.evaluate import evaluate_accuracy

    cfg, model = _load_model(args)
    data = _build_dataset(args.pipeline, cfg, args, mode=args.dataset)
    metrics = evaluate_accuracy(
        model, data, pipeline=args.pipeline,
        train_split=args.split == "train", use_lengths=args.true_lengths,
    )
    print(json.dumps(metrics))
    return 0


def cmd_prepare_skeletal(args) -> int:
    from mgr_tpu_torch.data.skeletal_pipeline import extract_directory

    ids = extract_directory(args.raw_dir, args.out_csv, split_at=args.split_at,
                            val_csv=args.val_csv, device=_device(args))
    print(json.dumps({"videos": len(ids)}))
    return 0


def cmd_prepare_audio(args) -> int:
    from mgr_tpu_torch.data.audio_pipeline import extract_directory

    ids = extract_directory(args.wav_dir, args.out_dir, device=_device(args))
    print(json.dumps({"files": len(ids)}))
    return 0


def cmd_prepare_rgb(args) -> int:
    from mgr_tpu_torch.data.rgb_pipeline import extract_directory

    ids = extract_directory(args.video_dir, args.skeletal_dir, args.out_dir,
                            out_dim=args.img_dim, device=_device(args))
    print(json.dumps({"videos": len(ids)}))
    return 0


def cmd_mix(args) -> int:
    from mgr_tpu_torch.data.mixer import mix_all

    info = mix_all(
        audio_train_csv=args.audio_train, audio_val_csv=args.audio_val,
        skeletal_train_csv=args.skeletal_train, skeletal_val_csv=args.skeletal_val,
        train_labels_csv=args.train_labels, val_labels_csv=args.val_labels,
        out_root=args.out_root, n_moved=args.n_moved,
    )
    print(json.dumps({"moved": len(info["moved"]), "kept": len(info["kept"])}))
    return 0


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model or featurizer runs: cuda (default; "
                        "fails without a card) or cpu")


def _add_common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workdir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--true-lengths", action="store_true",
                   help="mask CTC to true sequence lengths instead of the "
                        "reference's padded-length convention")
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset learning rate")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="write checkpoints every N epochs (the best state "
                        "is kept in memory and still flushed)")
    p.add_argument("--monitor", choices=("val", "train"), default="val",
                   help="loss that drives the best checkpoint and early stopping")
    p.add_argument("--mesh", default=None,
                   help="DATAxMODEL[xTIME] mesh of ranks, e.g. 4x1, 2x2, 1x4 or 2x2x2, "
                        "one process per rank under torchrun")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of training to this directory")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError on a non-finite loss or gradient norm "
                        "(one host sync a step; autograd anomaly mode)")
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write checkpoints from a background thread")
    p.add_argument("--cache-dir", default=None,
                   help="keep the featurized speech corpus (.npz) across runs")
    _add_device_flag(p)


def _add_corpus_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-dir")
    p.add_argument("--labels")
    p.add_argument("--skeletal-csv")
    p.add_argument("--audio-csv")
    p.add_argument("--audio-dir")
    p.add_argument("--true-lengths", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mgr-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train one pipeline")
    pt.add_argument("pipeline", choices=PIPELINES)
    pt.add_argument("--data-dir", help="per-file audio CSV dir / video dir")
    pt.add_argument("--labels", help="Id,Sequence label CSV")
    pt.add_argument("--skeletal-csv", help="monolithic skeletal CSV")
    pt.add_argument("--audio-csv", help="monolithic labelled audio CSV (early fusion)")
    pt.add_argument("--audio-dir", help="per-file audio CSV dir (late fusion)")
    pt.add_argument("--from-scratch", action="store_true",
                    help="late fusion: start from random encoders, not the workdir's "
                         "trained speech and skeletal ones")
    _add_common_train_flags(pt)
    pt.set_defaults(fn=cmd_train)

    pc = sub.add_parser("curriculum", help="3-stage speech -> skeletal -> late fusion")
    pc.add_argument("--audio-dir", required=True)
    pc.add_argument("--audio-labels", required=True)
    pc.add_argument("--skeletal-csv", required=True)
    pc.add_argument("--labels", required=True)
    _add_common_train_flags(pc)
    pc.set_defaults(fn=cmd_curriculum)

    pd = sub.add_parser("decode", help="decode a trained pipeline to MLF")
    pd.add_argument("pipeline", choices=PIPELINES)
    pd.add_argument("--workdir", default="runs")
    pd.add_argument("--dataset", default="val", choices=["val", "final"])
    pd.add_argument("--slot", default="best", choices=["best", "latest"])
    pd.add_argument("--out", default=None)
    _add_corpus_flags(pd)
    pd.add_argument("--beam", type=int, default=0,
                    help="prefix beam search width (0/1 = best path)")
    _add_device_flag(pd)
    pd.set_defaults(fn=cmd_decode)

    pe = sub.add_parser("evaluate", help="decode a split and score it in-framework")
    pe.add_argument("pipeline", choices=PIPELINES)
    pe.add_argument("--workdir", default="runs")
    pe.add_argument("--dataset", default="train", choices=["train", "val", "final"])
    pe.add_argument("--split", default="val", choices=["train", "val"],
                    help="which side of the split to score (dataset=train)")
    pe.add_argument("--slot", default="best", choices=["best", "latest"])
    _add_corpus_flags(pe)
    _add_device_flag(pe)
    pe.set_defaults(fn=cmd_evaluate)

    pi = sub.add_parser("infer", help="decode one utterance file")
    pi.add_argument("pipeline", choices=["speech", "skeletal", "rgb"])
    pi.add_argument("input", help="audio CSV / skeletal CSV / video npy")
    pi.add_argument("--workdir", default="runs")
    pi.add_argument("--slot", default="best", choices=["best", "latest"])
    pi.add_argument("--true-lengths", action="store_true")
    _add_device_flag(pi)
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("score", help="HTK-style scoring of two MLFs")
    ps.add_argument("refs")
    ps.add_argument("hyps")
    ps.add_argument("--partial", action="store_true",
                    help="ignore refs missing from hyps")
    ps.set_defaults(fn=cmd_score)

    pk = sub.add_parser("prepare-skeletal", help="raw Kinect CSVs -> monolithic feature CSV")
    pk.add_argument("--raw-dir", required=True)
    pk.add_argument("--out-csv", required=True)
    pk.add_argument("--val-csv", default=None)
    pk.add_argument("--split-at", type=int, default=None,
                    help="file id boundary (reference uses 403)")
    _add_device_flag(pk)
    pk.set_defaults(fn=cmd_prepare_skeletal)

    pa = sub.add_parser("prepare-audio",
                        help="WAVs -> 39-d MFCC per-file CSVs (replaces HTK HCopy)")
    pa.add_argument("--wav-dir", required=True)
    pa.add_argument("--out-dir", required=True)
    _add_device_flag(pa)
    pa.set_defaults(fn=cmd_prepare_audio)

    pr = sub.add_parser("prepare-rgb",
                        help="videos + raw Kinect CSVs -> cropped upper-body (T,60,60,1) .npy")
    pr.add_argument("--video-dir", required=True)
    pr.add_argument("--skeletal-dir", required=True)
    pr.add_argument("--out-dir", required=True)
    pr.add_argument("--img-dim", type=int, default=60)
    _add_device_flag(pr)
    pr.set_defaults(fn=cmd_prepare_rgb)

    pm = sub.add_parser("mix", help="move N val files into training across all streams")
    pm.add_argument("--audio-train", required=True)
    pm.add_argument("--audio-val", required=True)
    pm.add_argument("--skeletal-train", required=True)
    pm.add_argument("--skeletal-val", required=True)
    pm.add_argument("--train-labels", required=True)
    pm.add_argument("--val-labels", required=True)
    pm.add_argument("--out-root", required=True)
    pm.add_argument("--n-moved", type=int, default=95)
    pm.set_defaults(fn=cmd_mix)

    pb = sub.add_parser("bench", help="train and decode throughput, or B=1 latency, "
                                      "of one pipeline on one card")
    bench.add_arguments(pb)
    pb.set_defaults(fn=bench.run)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
