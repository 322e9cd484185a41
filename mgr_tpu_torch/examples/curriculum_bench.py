"""The three-stage curriculum's wall clock at ChaLearn geometry
(``examples/curriculum_bench.py`` of the JAX package).

Trains the reference's recipe (speech, then skeletal, then late fusion on
their grafted, frozen encoders) at the reference's geometry: 400 train and
300 val sequences a stage, 1900 padded frames, 39 audio and 20 skeletal
features, BiLSTM(500)x2 speech, BiLSTM(300)x2 skeletal and a BiLSTM(100)
fusion layer, CTC over 44 and 22 classes. The reference trains this in
about 100 hours on a GTX 1060 at batch 2. Here each stage is a ``fit``
over the corpus held on the card. The features are class-signature
signals, made in memory from a seed, so the corpus is learnable.

    python -m mgr_tpu_torch.examples.curriculum_bench [--device cpu]

Prints one JSON line (metric ``curriculum_wall_clock``, the JAX line's
keys). By default a 12-epoch timing run: the median epoch from epoch 2 on,
times the reference's 500-epoch ceiling, is the projection.
``MGR_TPU_CB_MEASURED=1`` trains every stage for real, on the train loss,
and decodes its best state: ``MGR_TPU_CB_TARGET`` stops a stage at a train
loss, ``MGR_TPU_CB_ACC_TARGET`` at a decoded train accuracy, probed every
``MGR_TPU_CB_ACC_EVERY`` epochs, each probe its own ``fit(resume=True)``
chunk with one plateau controller for the whole stage. A late-fusion
stage that misses its accuracy target goes on for up to
``MGR_TPU_CB_FINETUNE_EPOCHS`` with its encoders unfrozen at
``MGR_TPU_CB_FINETUNE_LR``. Per-stage batch, LR and blank bias:
``MGR_TPU_CB_STAGE_BATCH``, ``MGR_TPU_CB_STAGE_LR``,
``MGR_TPU_CB_BLANK_BIAS`` (``core.config.parse_stage_table``).
``MGR_TPU_CB_WORKDIR`` keeps the checkpoints, so that a relaunch resumes;
it is pinned to the corpus geometry it was written with. The other knobs:
``MGR_TPU_CB_{NTRAIN,NVAL,EPOCHS,MAXLEN,BATCH,HIDDEN_SCALE,LR,SYNC_EVERY}``.

One thing differs from the JAX script on purpose: the finetune leg starts
at its own LR with a fresh plateau controller. JAX's resume hands that
controller the frozen leg's annealed state; the port drops it from the
stage's fitmeta before the leg.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.data.synthetic import _class_signal
from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
from mgr_tpu_torch.examples import common
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train import optimizer as opt_lib
from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained
from mgr_tpu_torch.train.loop import fit
from mgr_tpu_torch.train.step import create_train_state

METRIC = "curriculum_wall_clock"
REF_EPOCH_CEILING = 500
REF_TOTAL_HOURS = 100.0


def knobs() -> SimpleNamespace:
    """The ``MGR_TPU_CB_*`` environment, with the JAX script's defaults."""
    env = os.environ.get
    measured = env("MGR_TPU_CB_MEASURED") == "1"
    return SimpleNamespace(
        n_train=int(env("MGR_TPU_CB_NTRAIN", "400")),
        n_val=int(env("MGR_TPU_CB_NVAL", "300")),
        measured=measured,
        # The short mode's epochs 0-1 are its warm-up.
        epochs=int(env("MGR_TPU_CB_EPOCHS", "500" if measured else "12")),
        maxlen=int(env("MGR_TPU_CB_MAXLEN", "0")) or None,
        batch=int(env("MGR_TPU_CB_BATCH", "0")) or None,
        hidden_scale=float(env("MGR_TPU_CB_HIDDEN_SCALE", "1")),
        # The measured mode's large-batch LR.
        lr=float(env("MGR_TPU_CB_LR", "3e-3")),
        sync_every=int(env("MGR_TPU_CB_SYNC_EVERY", "1")),
        target=env("MGR_TPU_CB_TARGET", ""),
        acc_target=env("MGR_TPU_CB_ACC_TARGET", ""),
        acc_every=int(env("MGR_TPU_CB_ACC_EVERY", "100")),
        ft_epochs=int(env("MGR_TPU_CB_FINETUNE_EPOCHS", "0") or 0),
        ft_lr=float(env("MGR_TPU_CB_FINETUNE_LR", "3e-4")),
        # A bare float biases late fusion only; a table names stages.
        blank_bias=env("MGR_TPU_CB_BLANK_BIAS", ""),
        stage_batch=env("MGR_TPU_CB_STAGE_BATCH", ""),
        stage_lr=env("MGR_TPU_CB_STAGE_LR", ""),
        workdir=env("MGR_TPU_CB_WORKDIR", ""),
    )


def make_batcher(k, cfg: cfglib.PipelineConfig, *, n_labels: int, seed: int) -> Batcher:
    """A stage's corpus in memory at the reference's geometry: class-
    signature signals, ``n_labels`` labels a sequence, every sequence
    padded to ``cfg.maxlen``."""
    rng = np.random.default_rng(seed)
    n = k.n_train + k.n_val
    T = cfg.maxlen
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    seqs = rng.integers(1, cfg.nb_classes - 1, size=(n, n_labels))
    labels[:, :n_labels] = seqs
    frames_per = max(T // n_labels - 4, 1)

    def stream(F, srng):
        x = np.zeros((n, T, F), np.float32)
        for i in range(n):
            sig = _class_signal(srng, seqs[i], frames_per, F)[:T]
            x[i, : sig.shape[0]] = sig
        return x

    if cfg.second_stream_feats:
        feats = (stream(cfg.num_feats, rng), stream(cfg.second_stream_feats, rng))
    else:
        feats = stream(cfg.num_feats, rng)
    return Batcher(
        features=feats,
        labels=labels,
        label_lengths=np.full((n,), n_labels, np.int32),
        input_lengths=np.full((n,), T - cfg.ctc.trim_frames, np.int32),
        file_ids=list(range(n)),
        train_ids=list(range(k.n_train)),
        val_ids=list(range(k.n_train, n)),
    )


def _bench_stage(k, cfg, data, workdir, device, *, resume=False, source_configs=None) -> dict:
    # source_configs: the scaled encoder configs the graft used.
    model = build_model(cfg, source_configs, device=device)
    t0 = time.time()
    target = cfglib.parse_stage_table(k.target, cfg.name) if k.measured else None
    acc_target = cfglib.parse_stage_table(k.acc_target, cfg.name) if k.measured else None
    # One plateau controller for the whole stage: the chunks of the
    # accuracy loop keep its annealed rate.
    plateau_ctl = opt_lib.plateau_from_config(cfg)
    nb = max(data.num_batches(cfg.batch_size, train=True), 1)

    def _fit(up_to, resume_now):
        return fit(model, data, workdir=workdir, epochs=up_to, resume=resume_now,
                   checkpoint_every=100,
                   monitor="train" if k.measured else "val",
                   keep_best_state=k.measured,
                   sync_every=k.sync_every,
                   stop_below=target,
                   plateau_controller=plateau_ctl)

    acc_probe = None
    finetuned_epochs = 0
    if acc_target is None:
        result = _fit(k.epochs, resume)
    else:
        # Wall clock to accuracy: ACC_EVERY-epoch chunks, the chunk's best
        # state decoded and scored between them (the probes count).
        def _acc_chunks(start, until, resume_now):
            nonlocal acc_probe
            done, res = start, None
            while done < until:
                up_to = min(done + k.acc_every, until)
                res = _fit(up_to, resume_now or done > start)
                done = up_to
                probe = res.best_state if res.best_state is not None else res.state
                with common.params_loaded(model, probe.params):
                    acc_probe = evaluate_accuracy(model, data, train_split=True)["accuracy"]
                print(f"[{cfg.name}] acc probe @ep{done}: {acc_probe:.4f} "
                      f"(target {acc_target})", flush=True)
                if acc_probe >= acc_target:
                    break
            if res is None:  # no chunk ran (a relaunch already at its target)
                res = _fit(until, resume_now)
            return res

        result = _acc_chunks(0, k.epochs, resume)
        if (acc_probe is not None and acc_probe < acc_target
                and k.ft_epochs > 0 and cfg.fusion_sources):
            # The finetune continuation: the grafted encoders unfrozen for
            # up to FT_EPOCHS more, at FT_LR with a fresh controller.
            cfg_ft = cfg.replace(
                finetune_encoders=True,
                optimizer=dataclasses.replace(cfg.optimizer, learning_rate=k.ft_lr))
            model = build_model(cfg_ft, source_configs, device=device)
            plateau_ctl = opt_lib.plateau_from_config(cfg_ft)
            # JAX's resume would hand that controller the frozen leg's
            # annealed state: the leg's fitmeta starts without one.
            meta = ckpt_lib.load_fit_meta(workdir, cfg.name)
            meta.pop("plateau", None)
            ckpt_lib.save_fit_meta(workdir, cfg.name, meta)
            epochs_before = int(result.state.step) // nb
            result = _acc_chunks(epochs_before, epochs_before + k.ft_epochs, True)
            finetuned_epochs = int(result.state.step) // nb - epochs_before
    wall = time.time() - t0
    steady = result.history[2:] or result.history
    # A window's wall over its epochs; a resume already at its target has
    # no history.
    epoch_s = statistics.median(
        rec["wall_s"] / rec.get("epochs_in_record", 1) for rec in steady
    ) if steady else 0.0
    out = {
        "epoch_s": round(epoch_s, 3),
        "as_run_s": round(wall, 1),
        "projected_500ep_s": round(epoch_s * REF_EPOCH_CEILING, 1),
    }
    if k.measured:
        best = result.best_state if result.best_state is not None else result.state
        with common.params_loaded(model, best.params):
            acc = evaluate_accuracy(model, data, train_split=True)
        # The checkpointed step counts every chunk of the stage.
        out["epochs_run"] = int(result.state.step) // nb
        out["train_accuracy"] = round(acc["accuracy"], 4)
        out["train_wer"] = round(acc["wer"], 4)
        out["best_train_loss"] = round(result.best_val_loss, 3)
        if target is not None:
            out["target_loss"] = target
            out["reached_target"] = bool(result.best_val_loss < target)
        if acc_target is not None:
            out["target_accuracy"] = acc_target
            out["reached_accuracy_target"] = bool(acc_probe is not None
                                                  and acc_probe >= acc_target)
            if finetuned_epochs:
                out["finetune_epochs"] = finetuned_epochs
                out["finetune_lr"] = k.ft_lr
        # The graft reads the best-train state, not the last one.
        if workdir:
            ckpt_lib.save_train_state(workdir, cfg.name, best, slot="best")
    return out


def stage_configs(k) -> dict:
    """The three stages' configs: the presets at the benchmark's batches
    (128, 128, 64) or the stage tables', and in the measured mode the
    large-batch LR, the regularization scaled down for a synthetic
    corpus, a plateau anneal on the train loss and the blank biases."""
    def scaled(name, batch):
        stage_batch = cfglib.parse_stage_table(k.stage_batch, name)
        stage_lr = cfglib.parse_stage_table(k.stage_lr, name)
        cfg = cfglib.get_preset(name).replace(
            batch_size=int(stage_batch) if stage_batch else (k.batch or batch),
            patience=k.epochs + 1,
        )
        if k.measured:
            cfg = cfg.replace(
                optimizer=dataclasses.replace(cfg.optimizer,
                                              learning_rate=stage_lr or k.lr),
                encoder=dataclasses.replace(
                    cfg.encoder, input_noise=0.05,
                    dropout=tuple(0.02 for _ in cfg.encoder.dropout),
                    output_dropout=0.02),
                fusion_dropout=0.02,
                fusion_output_dropout=0.02,
                reduce_lr_factor=0.5,
                reduce_lr_patience=15,
                reduce_lr_min=1e-4,
            )
            bias = (cfglib.parse_stage_table(k.blank_bias, name) if ":" in k.blank_bias
                    else (float(k.blank_bias or 0) if name == "late_fusion" else None))
            if bias:
                cfg = cfg.replace(head_blank_bias=bias)
        if k.maxlen:
            cfg = cfg.replace(maxlen=k.maxlen)
        if k.hidden_scale != 1:
            enc = dataclasses.replace(
                cfg.encoder, hidden=max(4, int(cfg.encoder.hidden * k.hidden_scale)))
            cfg = cfg.replace(encoder=enc,
                              fusion_hidden=max(4, int(cfg.fusion_hidden * k.hidden_scale)))
        return cfg

    return {"speech": scaled("speech", 128), "skeletal": scaled("skeletal", 128),
            "late_fusion": scaled("late_fusion", 64)}


def _pin_geometry(k, workdir: str) -> None:
    """Refuse a persistent workdir written with another corpus geometry:
    ``fit``'s batches-per-epoch check misses same-ratio changes."""
    fp = {"n_train": k.n_train, "n_val": k.n_val, "maxlen": k.maxlen,
          "batch": k.batch, "hidden_scale": k.hidden_scale, "lr": k.lr}
    fp_path = os.path.join(workdir, "cb_fingerprint.json")
    if os.path.exists(fp_path):
        with open(fp_path) as f:
            old = json.load(f)
        if old != fp:
            raise SystemExit(
                f"MGR_TPU_CB_WORKDIR={workdir} was written with different geometry "
                f"{old} (this run: {fp}) — resuming would silently skip or corrupt "
                f"stages; relaunch with the original env or a fresh workdir")
    else:
        with open(fp_path, "w") as f:
            json.dump(fp, f)


def main(device: str = "cuda") -> dict:
    """Runs the three stages on ``device``; prints and returns the JSON row."""
    common.resolve_device(device, "curriculum_bench")
    k = knobs()
    stages = stage_configs(k)
    label_counts = {"speech": 20, "skeletal": 10, "late_fusion": 10}
    out = {}
    if k.workdir:
        os.makedirs(k.workdir, exist_ok=True)
        _pin_geometry(k, k.workdir)
        ctx = contextlib.nullcontext(k.workdir)
    else:
        ctx = tempfile.TemporaryDirectory()
    with ctx as workdir:
        for i, (name, cfg) in enumerate(stages.items()):
            data = make_batcher(k, cfg, n_labels=label_counts[name], seed=i)
            if name == "late_fusion":
                srcs = {s: stages[s] for s in ("speech", "skeletal")}
                # On a relaunch a late_fusion checkpoint means the graft
                # already happened: seeding latest again would lose it.
                if not ckpt_lib.has_checkpoint(workdir, cfg.name, "latest"):
                    fusion = build_fusion_with_pretrained(workdir, cfg, srcs, device=device)
                    ckpt_lib.save_train_state(workdir, cfg.name, create_train_state(fusion),
                                              slot="latest")
                out[name] = _bench_stage(k, cfg, data, workdir, device, resume=True,
                                         source_configs=srcs)
            else:
                # resume without a checkpoint is a fresh start.
                out[name] = _bench_stage(k, cfg, data, workdir, device,
                                         resume=bool(k.workdir))

    total_projected = sum(s["projected_500ep_s"] for s in out.values())
    result = {
        "metric": METRIC,
        "measured": k.measured,
        "stages": out,
        "projected_500ep_total_s": round(total_projected, 1),
        "projected_500ep_total_min": round(total_projected / 60.0, 1),
        "reference_hours": REF_TOTAL_HOURS,
        "speedup_vs_reference": round(REF_TOTAL_HOURS * 3600.0 / total_projected, 1)
        if total_projected > 0 else None,
    }
    if k.measured:
        total = sum(s["as_run_s"] for s in out.values())
        result["measured_total_s"] = round(total, 1)
        result["measured_total_min"] = round(total / 60.0, 1)
        result["measured_speedup_vs_reference"] = round(REF_TOTAL_HOURS * 3600.0 / total, 1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    common.run_cli(main, __doc__.split("\n\n")[0])
