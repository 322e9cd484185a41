"""Convergence check at full geometry (``examples/tpu_convergence_check.py``
of the JAX package).

Trains each pipeline on a separable synthetic corpus in the reference's
on-disk formats, at the production path: bf16, the kernels, 1900-frame
padded geometry, the reference's CTC semantics (padded-length parity,
2-frame trim), per-gate dropout, maxnorm(3), input noise and Adam decay.
It reports the decoded train token accuracy of the best-train state:
whether the recipe memorizes what it is given.

    python -m mgr_tpu_torch.examples.convergence_check [--device cpu]

Prints one JSON line (metric ``tpu_production_path_convergence``, the JAX
line's keys). The stages: speech and skeletal by default;
``MGR_TPU_CONV_ONLY`` picks one of speech, skeletal, late_fusion (pretrain
both encoders with resume, graft them, train the frozen-encoder head,
then an optional anneal leg), early_fusion or rgb. Every knob of the JAX
script is read under its name and default: ``MGR_TPU_CONV_{FILES,EPOCHS,
MAXLEN,BATCH,LR,ONLY,HIDDEN_SCALE,SYNC,ROOT,GUARD,PLATEAU,
PRETRAIN_BLANK_BIAS,PRETRAIN_LADDER,WORKDIR,FUSION_FPL,FUSION_LABELS,
PRETRAIN,PRETRAIN_LR2,PRETRAIN_EPOCHS2,REQUIRE_ENC,FUSION_BATCH,
BLANK_BIAS,RESUME,LR2,EPOCHS2,FINETUNE,RGB_MAXLEN,RGB_FILES,RGB_BATCH,
RGB_LR}``. ``HIDDEN_SCALE`` shrinks every hidden width for a CPU run; the
check itself runs at scale 1. At these defaults skeletal needs about 1000
epochs to leave the CTC all-blank basin (400 is not enough).
``MGR_TPU_CONV_REQUIRE_ENC`` exits with code 3 before the fusion head
when an encoder decodes below it. One knob is the port's own:
``MGR_TPU_CONV_SEED`` sets every stage's config seed (the init, the
shuffles, the noise and dropout draws), to measure the spread of a result
over draws; unset, the presets' seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from types import SimpleNamespace

import torch

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.data import datasets, synthetic
from mgr_tpu_torch.decode.decoder import DECODE_SPECS
from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
from mgr_tpu_torch.examples import common
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained
from mgr_tpu_torch.train.loop import fit
from mgr_tpu_torch.train.step import create_train_state

METRIC = "tpu_production_path_convergence"


def knobs() -> SimpleNamespace:
    """The ``MGR_TPU_CONV_*`` environment, with the JAX script's defaults."""
    env = os.environ.get
    plateau = env("MGR_TPU_CONV_PLATEAU", "")
    if plateau in ("1", "true"):
        plateau = "0.5:50:3e-4"
    return SimpleNamespace(
        files=int(env("MGR_TPU_CONV_FILES", "96")),
        epochs=int(env("MGR_TPU_CONV_EPOCHS", "400")),
        maxlen=int(env("MGR_TPU_CONV_MAXLEN", "1900")),
        batch=int(env("MGR_TPU_CONV_BATCH", "32")),
        lr=float(env("MGR_TPU_CONV_LR", "3e-3")),
        only=env("MGR_TPU_CONV_ONLY", ""),
        hidden_scale=float(env("MGR_TPU_CONV_HIDDEN_SCALE", "1")),
        # Host reads once per SYNC epochs (fit(sync_every=...)).
        sync=int(env("MGR_TPU_CONV_SYNC", "10")),
        root=env("MGR_TPU_CONV_ROOT", ""),
        # Skip non-finite updates in every stage (skip_nonfinite=100).
        guard=int(env("MGR_TPU_CONV_GUARD", "0") or 0),
        # "factor:patience:min_lr[:min_delta]": ReduceLROnPlateau on the
        # train loss in every stage.
        plateau=tuple(float(x) for x in plateau.split(":")) if plateau else None,
        pretrain_blank_bias=env("MGR_TPU_CONV_PRETRAIN_BLANK_BIAS", ""),
        pretrain_ladder=env("MGR_TPU_CONV_PRETRAIN_LADDER", ""),
        workdir=env("MGR_TPU_CONV_WORKDIR", ""),
        fusion_fpl=int(env("MGR_TPU_CONV_FUSION_FPL", "90")),
        fusion_labels=int(env("MGR_TPU_CONV_FUSION_LABELS", "20")),
        pretrain=int(env("MGR_TPU_CONV_PRETRAIN", "0")),
        pretrain_lr2=float(env("MGR_TPU_CONV_PRETRAIN_LR2", "0") or 0),
        pretrain_epochs2=int(env("MGR_TPU_CONV_PRETRAIN_EPOCHS2", "0") or 0),
        require_enc=float(env("MGR_TPU_CONV_REQUIRE_ENC", "0") or 0),
        fusion_batch=int(env("MGR_TPU_CONV_FUSION_BATCH", "") or 0),
        blank_bias=float(env("MGR_TPU_CONV_BLANK_BIAS", "0") or 0),
        resume=env("MGR_TPU_CONV_RESUME") == "1",
        lr2=float(env("MGR_TPU_CONV_LR2", "0") or 0),
        epochs2=int(env("MGR_TPU_CONV_EPOCHS2", "0") or 0),
        finetune=env("MGR_TPU_CONV_FINETUNE") == "1",
        rgb_maxlen=int(env("MGR_TPU_CONV_RGB_MAXLEN", "80")),
        rgb_files=int(env("MGR_TPU_CONV_RGB_FILES", "48")),
        rgb_batch=int(env("MGR_TPU_CONV_RGB_BATCH", "8")),
        rgb_lr=float(env("MGR_TPU_CONV_RGB_LR", "1e-3")),
        seed=int(env("MGR_TPU_CONV_SEED", "") or -1),
    )


def _opt(k, lr: float) -> cfglib.OptimizerConfig:
    return cfglib.OptimizerConfig(learning_rate=lr, decay=1e-5, maxnorm=3.0,
                                  skip_nonfinite=100 if k.guard else 0)


def _seed(k) -> dict:
    return {"seed": k.seed} if k.seed >= 0 else {}


def _scaled(k, hidden: int) -> int:
    return max(4, int(hidden * k.hidden_scale))


def _plateau_fields(k) -> dict:
    if not k.plateau:
        return {}
    factor, patience, min_lr = k.plateau[:3]
    fields = {"reduce_lr_factor": factor, "reduce_lr_patience": int(patience),
              "reduce_lr_min": min_lr}
    if len(k.plateau) > 3:
        fields["reduce_lr_min_delta"] = k.plateau[3]
    return fields


def pretrain_ladder(raw: str, stage: str) -> list:
    """``"skeletal:3e-4x5000+1e-4x8000"``: '+'-separated legs of LRxTOTAL
    (cumulative epoch targets, so a relaunch is idempotent),
    ';'-separated stages. A malformed or descending ladder exits at once,
    naming the leg."""
    for part in raw.split(";") if raw else ():
        name, _, legs = part.partition(":")
        if name.strip() != stage or not legs:
            continue
        out = []
        for leg in legs.split("+"):
            lr, sep, total = leg.partition("x")
            if not sep or not lr.strip() or not total.strip():
                raise SystemExit(f"MGR_TPU_CONV_PRETRAIN_LADDER: leg '{leg}' of stage "
                                 f"'{stage}' is not LRxTOTAL (e.g. '1e-4x8000')")
            try:
                out.append((float(lr), int(total)))
            except ValueError as e:
                raise SystemExit(f"MGR_TPU_CONV_PRETRAIN_LADDER: leg '{leg}' of stage "
                                 f"'{stage}': {e}") from None
        totals = [t for _, t in out]
        if totals != sorted(totals):
            raise SystemExit(f"MGR_TPU_CONV_PRETRAIN_LADDER: stage '{stage}' totals "
                             f"{totals} must be ascending (cumulative epoch targets; "
                             f"a descending leg silently no-ops)")
        return out
    return []


def _parity_overrides(k, cfg: cfglib.PipelineConfig, hidden: int) -> cfglib.PipelineConfig:
    """Production widths and the reference's semantics, with the
    regularization rates scaled down for a small synthetic corpus."""
    cfg = cfg.replace(
        maxlen=k.maxlen, batch_size=k.batch,
        encoder=cfglib.EncoderConfig(
            hidden=_scaled(k, hidden), depth=2, input_noise=0.05,
            dropout=(0.02, 0.02), output_dropout=0.02, per_gate_dropout=True),
        optimizer=_opt(k, k.lr),
        patience=10_000,
        **_seed(k),
        # An init-time bias of the head's blank logit (fresh heads only).
        head_blank_bias=cfglib.parse_stage_table(
            k.pretrain_blank_bias, cfg.name, default=0.0) or 0.0,
        **_plateau_fields(k),
    )
    assert cfg.ctc.padded_length_parity and cfg.ctc.trim_frames == 2
    assert cfg.compute_dtype == "bfloat16", "must run the production dtype"
    return cfg


def _run(k, cfg, ds, device) -> dict:
    # monitor="train" with the best state kept: on a memorization corpus
    # the val loss rises once the train split is fit.
    model = build_model(cfg, device=device)
    t0 = time.time()
    res = fit(model, ds, workdir=None, epochs=k.epochs, monitor="train",
              keep_best_state=True, sync_every=k.sync)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    with common.params_loaded(model, best.params):
        acc = evaluate_accuracy(model, ds, train_split=True)
    return {
        "train_accuracy": round(acc["accuracy"], 4),
        "train_wer": round(acc["wer"], 4),
        "epochs": res.epochs_run,
        "wall_s": round(wall, 1),
        "best_train_loss": round(res.best_val_loss, 3),
    }


def _run_fusion(k, root: str, device) -> dict:
    """Pretrain both encoders (resumable), graft them into the late-fusion
    model as the curriculum does, and train its head on frozen encoders;
    then an optional anneal leg (``LR2``/``EPOCHS2``, unfrozen encoders
    with ``FINETUNE=1``). Both streams encode the same gestures per file
    on one clock (audio at 5x the skeletal frame rate)."""
    workdir = k.workdir or os.path.join(root, "fusion_wd")
    os.makedirs(workdir, exist_ok=True)
    reuse = bool(k.root)
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=k.files, frames_per_label=k.fusion_fpl,
        max_labels=k.fusion_labels, seed=4, reuse=reuse)
    audio_dir, _, _ = synthetic.make_audio_dataset(
        root, n_files=k.files, n_classes=22, frames_per_label=5 * k.fusion_fpl,
        seed=0, labels=labels, reuse=reuse)

    pretrain_epochs = k.pretrain or k.epochs
    sp_cfg = _parity_overrides(k, cfglib.get_preset("speech"), 500)
    sk_cfg = _parity_overrides(k, cfglib.get_preset("skeletal"), 300)
    encoder_quality = {}
    for name, cfg, ds in (
        ("speech", sp_cfg, datasets.build_audio_dataset(audio_dir, sk_labels, sp_cfg)),
        ("skeletal", sk_cfg, datasets.build_skeletal_dataset(sk_csv, sk_labels, sk_cfg)),
    ):
        # The best slot holds the best-train state (what the graft reads);
        # resume makes the pretrain restartable and a finished one free.
        fit(build_model(cfg, device=device), ds, workdir=workdir, resume=True,
            epochs=pretrain_epochs, checkpoint_every=100, monitor="train",
            sync_every=k.sync)
        ladder = pretrain_ladder(k.pretrain_ladder, name) or (
            [(k.pretrain_lr2, pretrain_epochs + k.pretrain_epochs2)]
            if k.pretrain_lr2 > 0 and k.pretrain_epochs2 > 0 else [])
        for leg_lr, leg_total in ladder:
            cfg2 = cfg.replace(optimizer=_opt(k, leg_lr))
            fit(build_model(cfg2, device=device), ds, workdir=workdir, resume=True,
                epochs=leg_total, checkpoint_every=100, monitor="train",
                sync_every=k.sync)
        enc_model = build_model(cfg, device=device)
        ckpt_lib.load_params(workdir, name, enc_model, slot="best")
        acc = evaluate_accuracy(enc_model, ds, train_split=True)
        encoder_quality[name] = round(acc["accuracy"], 4)

    if k.require_enc and min(encoder_quality.values()) < k.require_enc:
        print(json.dumps({"metric": METRIC, "aborted": "encoder_below_floor",
                          "require_enc": k.require_enc,
                          "encoder_train_accuracy": encoder_quality}))
        raise SystemExit(3)

    lf = cfglib.get_preset("late_fusion")
    fusion_batch = k.fusion_batch if k.fusion_batch > 0 else k.batch
    lf_cfg = lf.replace(
        maxlen=k.maxlen, batch_size=fusion_batch,
        fusion_hidden=_scaled(k, lf.fusion_hidden),
        encoder=dataclasses.replace(lf.encoder, input_noise=0.05, output_dropout=0.02,
                                    per_gate_dropout=True),
        fusion_dropout=0.02, fusion_output_dropout=0.02,
        optimizer=_opt(k, k.lr),
        patience=10_000,
        **_seed(k),
        head_blank_bias=k.blank_bias,
        **_plateau_fields(k),
    )
    sources = {"speech": sp_cfg, "skeletal": sk_cfg}
    resume_fusion = k.resume and ckpt_lib.has_checkpoint(workdir, "late_fusion", "latest")
    model = build_fusion_with_pretrained(workdir, lf_cfg, sources, device=device)
    if not resume_fusion:
        # Seed the latest slot with the grafted state (a fresh head); with
        # RESUME=1 an existing fusion checkpoint continues instead.
        ckpt_lib.save_train_state(workdir, lf_cfg.name, create_train_state(model),
                                  slot="latest")
    fusion_ds = datasets.build_late_fusion_dataset(audio_dir, sk_csv, sk_labels, lf_cfg)
    t0 = time.time()
    res = fit(model, fusion_ds, workdir=workdir, resume=True, epochs=k.epochs,
              checkpoint_every=100, monitor="train", keep_best_state=True,
              sync_every=k.sync)
    anneal = k.lr2 > 0 and k.epochs2 > 0
    if anneal:
        lf_cfg2 = lf_cfg.replace(optimizer=_opt(k, k.lr2), finetune_encoders=k.finetune)
        model = build_model(lf_cfg2, sources, device=device)
        res = fit(model, fusion_ds, workdir=workdir, resume=True,
                  epochs=k.epochs + k.epochs2, checkpoint_every=100, monitor="train",
                  keep_best_state=True, sync_every=k.sync)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    with common.params_loaded(model, best.params):
        acc = evaluate_accuracy(model, fusion_ds, train_split=True)
        # Threshold 0 separates "wrong structure" from "not yet confident".
        acc0 = evaluate_accuracy(
            model, fusion_ds, train_split=True,
            spec=dataclasses.replace(DECODE_SPECS["late_fusion"], threshold=0.0,
                                     drop_blank=True))
    return {
        "train_accuracy": round(acc["accuracy"], 4),
        "train_wer": round(acc["wer"], 4),
        "train_accuracy_no_threshold": round(acc0["accuracy"], 4),
        "encoder_train_accuracy": encoder_quality,
        "epochs": k.epochs,
        "anneal_epochs": k.epochs2 if anneal else 0,
        "finetune_encoders": bool(k.finetune and anneal),
        "pretrain_epochs": pretrain_epochs,
        "wall_s": round(wall, 1),
        "best_train_loss": round(res.best_val_loss, 3),
    }


def _run_early_fusion(k, root: str, device) -> dict:
    """Monolithic labelled audio (x5 the skeletal rate) beside the skeletal
    stream, BiLSTM(500)x2 over their 59-feature concat."""
    reuse = bool(k.root)
    sk_csv, _, labels = synthetic.make_skeletal_dataset(
        root, n_files=k.files, frames_per_label=24, max_labels=4, seed=4, reuse=reuse)
    audio_csv = synthetic.make_monolithic_audio_dataset(
        root, labels, frames_per_label=120, seed=2, reuse=reuse)
    cfg = _parity_overrides(k, cfglib.get_preset("early_fusion"), 500)
    cfg = cfg.replace(second_stream_noise=0.05)
    ds = datasets.build_early_fusion_dataset(audio_csv, sk_csv, cfg)
    return _run(k, cfg, ds, device)


def _run_rgb(k, root: str, device) -> dict:
    """The CNN-LSTM at a smaller geometry (80 frames, 48 videos): the
    question is whether the bf16 conv frontend and the recurrence learn."""
    data_dir, label_file, _ = synthetic.make_rgb_dataset(
        root, n_files=k.rgb_files, frames_per_label=16, max_labels=4, seed=3,
        reuse=bool(k.root))
    preset = cfglib.get_preset("rgb")
    cfg = preset.replace(
        maxlen=k.rgb_maxlen,
        encoder=dataclasses.replace(preset.encoder, hidden=_scaled(k, preset.encoder.hidden)),
        batch_size=k.rgb_batch,
        optimizer=cfglib.OptimizerConfig(learning_rate=k.rgb_lr, maxnorm=3.0,
                                         skip_nonfinite=100 if k.guard else 0),
        patience=10_000,
        **_seed(k),
        **_plateau_fields(k),
    )
    assert cfg.compute_dtype == "bfloat16"
    ds = datasets.build_rgb_dataset(data_dir, label_file, cfg)
    return _run(k, cfg, ds, device)


def main(device: str = "cuda") -> dict:
    """Runs the stages ``MGR_TPU_CONV_ONLY`` names on ``device``; prints and
    returns the JSON row."""
    common.resolve_device(device, "convergence_check")
    k = knobs()
    out = {}
    if k.root:  # a persistent corpus root: the generators skip a rewrite
        os.makedirs(k.root, exist_ok=True)
        ctx = contextlib.nullcontext(k.root)
    else:
        ctx = tempfile.TemporaryDirectory()
    with ctx as root:
        reuse = bool(k.root)
        if k.only in ("", "skeletal"):
            sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
                root, n_files=k.files, frames_per_label=24, max_labels=4, seed=4,
                reuse=reuse)
            cfg = _parity_overrides(k, cfglib.get_preset("skeletal"), 300)
            out["skeletal"] = _run(k, cfg, datasets.build_skeletal_dataset(
                sk_csv, sk_labels, cfg), device)
        if k.only in ("", "speech"):
            audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
                os.path.join(root, "a"), n_files=k.files, n_classes=20,
                frames_per_label=150, max_labels=4, seed=0, reuse=reuse)
            cfg = _parity_overrides(k, cfglib.get_preset("speech"), 500)
            out["speech"] = _run(k, cfg, datasets.build_audio_dataset(
                audio_dir, audio_labels, cfg), device)
        if k.only == "late_fusion":
            out["late_fusion"] = _run_fusion(k, root, device)
        if k.only == "early_fusion":
            out["early_fusion"] = _run_early_fusion(k, root, device)
        if k.only == "rgb":
            out["rgb"] = _run_rgb(k, root, device)
    row = {"metric": METRIC,
           "geometry": {"maxlen": k.maxlen, "files": k.files,
                        "dtype": "bfloat16+" + (
                            "kernels" if torch.device(device).type == "cuda" else "plain")},
           **out}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    common.run_cli(main, __doc__.split("\n\n")[0])
