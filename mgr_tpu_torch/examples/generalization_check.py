"""Held-out generalization check (``examples/generalization_check.py`` of
the JAX package).

Drives the reference's quality-control loop end to end and reports
decoded accuracy on files no stage trained on:

  * corpus: every class has a fixed signature vector and every file is a
    fresh noise draw around it, so unseen files decode only if the model
    learned the classes rather than the files;
  * split: the reference's seeded 80/20 file split (``split_seed``);
  * selection: ``fit(monitor="val")`` with EarlyStopping, keeping the
    best-val state;
  * metric: token accuracy on the val split from that state, and on the
    train split for the gap.

    python -m mgr_tpu_torch.examples.generalization_check [--device cpu]

Prints a JSON line per stage and a last one (metric
``heldout_generalization``, the JAX line's keys). ``MGR_TPU_GEN_ONLY``
names the stages (comma-separated: speech, skeletal, late_fusion; default
speech,skeletal). Every knob of the JAX script is read under its name and
default: ``MGR_TPU_GEN_{FILES,EPOCHS,MAXLEN,BATCH,LR,ONLY,HIDDEN_SCALE,
SYNC,PATIENCE,ROOT,WORKDIR,GUARD,FPL,LABELS,MIN_LABELS,REQUIRE_ENC,
BLANK_BIAS,FUSION_BATCH,FUSION_LR,FUSION_EPOCHS,RLR,DROPOUT,NOISE,
PERGATE}``. ``PATIENCE`` counts val windows of ``SYNC`` epochs.

Two things differ from the JAX script on purpose. The late-fusion stage's
pretrains write their slots in a workdir of their own (``<WORKDIR>/
late_fusion``), so they never resume the uni-modal stages' ``speech`` and
``skeletal`` slots, which were trained on another corpus. And when a
pretrain fails ``REQUIRE_ENC``, its checkpoints go with its sentinel, so
that a relaunch retrains it instead of resuming the failed state.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time
from types import SimpleNamespace

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.data import datasets, synthetic
from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
from mgr_tpu_torch.examples import common
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained
from mgr_tpu_torch.train.loop import fit
from mgr_tpu_torch.train.step import create_train_state

METRIC = "heldout_generalization"


def knobs() -> SimpleNamespace:
    """The ``MGR_TPU_GEN_*`` environment, with the JAX script's defaults."""
    env = os.environ.get
    root = env("MGR_TPU_GEN_ROOT", "")
    return SimpleNamespace(
        # 200 files -> 160 train / 40 val at the reference's 0.2 split.
        files=int(env("MGR_TPU_GEN_FILES", "200")),
        epochs=int(env("MGR_TPU_GEN_EPOCHS", "2000")),
        maxlen=int(env("MGR_TPU_GEN_MAXLEN", "1900")),
        batch=int(env("MGR_TPU_GEN_BATCH", "32")),
        lr=float(env("MGR_TPU_GEN_LR", "3e-3")),
        only=env("MGR_TPU_GEN_ONLY", "speech,skeletal"),
        hidden_scale=float(env("MGR_TPU_GEN_HIDDEN_SCALE", "1")),
        sync=int(env("MGR_TPU_GEN_SYNC", "10")),
        # EarlyStopping patience, in val windows of SYNC epochs.
        patience=int(env("MGR_TPU_GEN_PATIENCE", "20")),
        root=root,
        # A persistent checkpoint dir (default <ROOT>/workdir): a relaunch
        # resumes each stage from its latest slot.
        workdir=env("MGR_TPU_GEN_WORKDIR", "") or (os.path.join(root, "workdir")
                                                   if root else ""),
        guard=int(env("MGR_TPU_GEN_GUARD", "0") or 0),
        # ChaLearn content density: 8-20 gestures of ~90 skeletal frames.
        fpl=int(env("MGR_TPU_GEN_FPL", "90")),
        max_labels=int(env("MGR_TPU_GEN_LABELS", "20")),
        min_labels=int(env("MGR_TPU_GEN_MIN_LABELS", "1") or 1),
        # The fusion path stops with code 3 when a pretrain decodes below it.
        require_enc=float(env("MGR_TPU_GEN_REQUIRE_ENC", "0") or 0),
        blank_bias=env("MGR_TPU_GEN_BLANK_BIAS", "skeletal:-3,late_fusion:-3"),
        # The frozen fusion head under the reference's small-batch dynamics.
        fusion_batch=int(env("MGR_TPU_GEN_FUSION_BATCH", "8") or 8),
        fusion_lr=float(env("MGR_TPU_GEN_FUSION_LR", "1e-4")),
        fusion_epochs=int(env("MGR_TPU_GEN_FUSION_EPOCHS", "0") or 0),
        # "stage:factor/patience/min_lr,...": ReduceLROnPlateau per stage.
        rlr=env("MGR_TPU_GEN_RLR", ""),
        # Per-stage regularization tables (bare float or "stage:val,...").
        dropout=env("MGR_TPU_GEN_DROPOUT", ""),
        noise=env("MGR_TPU_GEN_NOISE", ""),
        pergate=env("MGR_TPU_GEN_PERGATE", ""),
    )


def _rlr(k, stage: str) -> dict:
    spec = None
    for part in k.rlr.split(",") if k.rlr else ():
        name, _, val = part.partition(":")
        if name.strip() == stage and val.strip():
            spec = val.strip()
    if spec is None:
        return {}
    fields = spec.split("/")
    if len(fields) != 3:
        raise SystemExit(f"MGR_TPU_GEN_RLR entry for '{stage}' must be "
                         f"factor/patience/min_lr, got '{spec}'")
    return {"reduce_lr_factor": float(fields[0]), "reduce_lr_patience": int(fields[1]),
            "reduce_lr_min": float(fields[2])}


def _opt(k, lr: float) -> cfglib.OptimizerConfig:
    return cfglib.OptimizerConfig(learning_rate=lr, decay=1e-5, maxnorm=3.0,
                                  skip_nonfinite=100 if k.guard else 0)


def _blank_bias(k, stage: str) -> float:
    return cfglib.parse_stage_table(k.blank_bias, stage, default=0.0) or 0.0


def _cfg(k, name: str, hidden: int) -> cfglib.PipelineConfig:
    drop = cfglib.parse_stage_table(k.dropout, name, default=0.1)
    noise = cfglib.parse_stage_table(k.noise, name, default=0.1)
    pergate = bool(cfglib.parse_stage_table(k.pergate, name, default=1.0))
    cfg = cfglib.get_preset(name).replace(
        maxlen=k.maxlen, batch_size=k.batch,
        encoder=cfglib.EncoderConfig(
            hidden=max(4, int(hidden * k.hidden_scale)), depth=2,
            input_noise=noise, dropout=(drop, drop), output_dropout=drop,
            per_gate_dropout=pergate),
        optimizer=_opt(k, k.lr),
        patience=k.patience,
        head_blank_bias=_blank_bias(k, name),
        **_rlr(k, name),
    )
    assert cfg.ctc.padded_length_parity and cfg.ctc.trim_frames == 2
    return cfg


def _run(k, cfg, ds, device, *, workdir: str = "", epochs: int = 0,
         source_configs=None) -> dict:
    workdir = workdir or k.workdir
    epochs = epochs or k.epochs
    model = build_model(cfg, source_configs, device=device)
    t0 = time.time()
    if workdir:
        os.makedirs(workdir, exist_ok=True)
    # The reference's loop: monitor the val loss, stop on patience, keep
    # the best-val state. With a workdir the run checkpoints and resumes,
    # and the best slot (the best-val state across relaunches) is decoded.
    res = fit(model, ds, workdir=workdir or None, epochs=epochs, resume=bool(workdir),
              checkpoint_every=100, monitor="val", keep_best_state=True,
              sync_every=k.sync)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    params = best.params
    if workdir and ckpt_lib.has_checkpoint(workdir, cfg.name, "best"):
        params = ckpt_lib.read_params(workdir, cfg.name, slot="best")
    with common.params_loaded(model, params):
        val = evaluate_accuracy(model, ds, train_split=False)
        train = evaluate_accuracy(model, ds, train_split=True)
    return {
        "val_accuracy": round(val["accuracy"], 4),
        "val_wer": round(val["wer"], 4),
        "train_accuracy": round(train["accuracy"], 4),
        "generalization_gap": round(train["accuracy"] - val["accuracy"], 4),
        "epochs_run": res.epochs_run,
        "early_stopped": res.epochs_run < epochs,
        "best_val_loss": round(res.best_val_loss, 3),
        "wall_s": round(wall, 1),
    }


def _late_fusion_stage(k, root: str, reuse: bool, out: dict, device) -> None:
    """Held-out accuracy of the frozen-encoder curriculum under the
    quality-control loop: both streams share label sequences and a clock,
    the encoders pretrain with ``fit(monitor="val")`` on the shared train
    split, their best-val states are grafted and frozen, and the head
    trains under the reference's dynamics (small batch, constant 1e-4, a
    blank-biased fresh head). Its val split is files no stage trained on."""
    fus_root = os.path.join(root, "fusion")
    os.makedirs(fus_root, exist_ok=True)
    # The stage's own workdir: its pretrains' slots are not the uni-modal
    # stages' (those trained on another corpus under the same stamps).
    wd = os.path.join(k.workdir, "late_fusion") if k.workdir \
        else os.path.join(fus_root, "workdir")
    sk_csv, sk_lab, labels = synthetic.make_skeletal_dataset(
        fus_root, n_files=k.files, n_classes=22, frames_per_label=k.fpl,
        max_labels=k.max_labels, seed=12, reuse=reuse, min_labels=k.min_labels)
    audio_dir, _, _ = synthetic.make_audio_dataset(
        fus_root, n_files=k.files, n_classes=22, frames_per_label=5 * k.fpl,
        max_labels=k.max_labels, seed=11, labels=labels, reuse=reuse)
    cfg_sp = _cfg(k, "speech", 500)
    cfg_sk = _cfg(k, "skeletal", 300)
    pretrain_ds = (
        ("speech", cfg_sp, lambda: datasets.build_audio_dataset(audio_dir, sk_lab, cfg_sp)),
        ("skeletal", cfg_sk, lambda: datasets.build_skeletal_dataset(sk_csv, sk_lab, cfg_sk)),
    )
    for name, cfg, make_ds in pretrain_ds:
        # A sentinel per finished pretrain: a relaunch does not re-enter it.
        sent = os.path.join(root, f"pretrain_{name}.json") if k.root else ""
        if sent and os.path.exists(sent):
            with open(sent) as f:
                out[f"pretrain_{name}"] = json.load(f)
            continue
        row = _run(k, cfg, make_ds(), device, workdir=wd)
        out[f"pretrain_{name}"] = row
        print(json.dumps({"stage": f"pretrain_{name}", **row}), flush=True)
        if sent:
            with open(sent, "w") as f:
                json.dump(row, f)
    if k.require_enc:
        for name in ("speech", "skeletal"):
            acc = out[f"pretrain_{name}"]["train_accuracy"]
            if acc < k.require_enc:
                print(json.dumps({
                    "metric": METRIC,
                    "aborted": f"pretrain_{name} train accuracy {acc} < REQUIRE_ENC "
                               f"{k.require_enc}",
                    **out,
                }), flush=True)
                # A relaunch retrains the failed pretrain from its init: its
                # sentinel and its checkpoints go.
                sent = os.path.join(root, f"pretrain_{name}.json")
                if k.root and os.path.exists(sent):
                    os.remove(sent)
                for path in glob.glob(os.path.join(glob.escape(wd), f"{name}_*")):
                    os.remove(path)
                raise SystemExit(3)
    lf_cfg = cfglib.get_preset("late_fusion").replace(
        maxlen=k.maxlen, batch_size=k.fusion_batch,
        optimizer=_opt(k, k.fusion_lr),
        patience=k.patience,
        head_blank_bias=_blank_bias(k, "late_fusion"),
        fusion_dropout=0.1, fusion_output_dropout=0.1,
        **_rlr(k, "late_fusion"),
    )
    sources = {"speech": cfg_sp, "skeletal": cfg_sk}
    ds_lf = datasets.build_late_fusion_dataset(audio_dir, sk_csv, sk_lab, lf_cfg)
    # Graft the best-val encoders and seed the head's latest slot, unless a
    # relaunch already has fusion progress there.
    if not ckpt_lib.has_checkpoint(wd, lf_cfg.name, "latest"):
        model = build_fusion_with_pretrained(wd, lf_cfg, sources, slot="best",
                                             device=device)
        ckpt_lib.save_train_state(wd, lf_cfg.name, create_train_state(model),
                                  slot="latest")
    out["late_fusion"] = _run(k, lf_cfg, ds_lf, device, workdir=wd,
                              epochs=k.fusion_epochs, source_configs=sources)
    print(json.dumps({"stage": "late_fusion", **out["late_fusion"]}), flush=True)


def main(device: str = "cuda") -> dict:
    """Runs the stages ``MGR_TPU_GEN_ONLY`` names on ``device``; prints and
    returns the last JSON row. A pretrain below ``REQUIRE_ENC`` exits with
    code 3."""
    common.resolve_device(device, "generalization_check")
    k = knobs()
    stages = [s.strip() for s in k.only.split(",") if s.strip()]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = k.root or tmp
        os.makedirs(root, exist_ok=True)
        reuse = bool(k.root)
        if "speech" in stages:
            # Audio at 5x the skeletal frame rate, as in the real dataset.
            audio_dir, lab, _ = synthetic.make_audio_dataset(
                root, n_files=k.files, n_classes=22, frames_per_label=5 * k.fpl,
                max_labels=k.max_labels, seed=11, reuse=reuse, min_labels=k.min_labels)
            cfg = _cfg(k, "speech", 500)
            out["speech"] = _run(k, cfg, datasets.build_audio_dataset(audio_dir, lab, cfg),
                                 device)
            print(json.dumps({"stage": "speech", **out["speech"]}), flush=True)
        if "skeletal" in stages:
            sk_csv, sk_lab, _ = synthetic.make_skeletal_dataset(
                root, n_files=k.files, n_classes=22, frames_per_label=k.fpl,
                max_labels=k.max_labels, seed=12, reuse=reuse, min_labels=k.min_labels)
            cfg = _cfg(k, "skeletal", 300)
            out["skeletal"] = _run(k, cfg, datasets.build_skeletal_dataset(
                sk_csv, sk_lab, cfg), device)
            print(json.dumps({"stage": "skeletal", **out["skeletal"]}), flush=True)
        if "late_fusion" in stages:
            _late_fusion_stage(k, root, reuse, out, device)
    row = {"metric": METRIC, "n_files": k.files, "val_split": 0.2, "maxlen": k.maxlen,
           **out}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    common.run_cli(main, __doc__.split("\n\n")[0])
