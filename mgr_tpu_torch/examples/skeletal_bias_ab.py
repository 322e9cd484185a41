"""The skeletal pretrain's blank-bias A/B at ChaLearn content density
(``examples/skeletal_bias_ab.py`` of the JAX package).

A trainable skeletal encoder on a corpus whose gestures fill most of the
padded window (8 gestures of ~90 frames) can sit at its CTC all-blank
floor at the big-batch LR; ``PipelineConfig.head_blank_bias`` (an
init-time bias of the head's blank logit) is the lever. Both arms run the
same recipe, a constant LR1 for EPOCHS1 epochs, then an LR2 leg up to
EPOCHS1+EPOCHS2, on the train loss with the non-finite guard on, and
differ only in the bias.

    python -m mgr_tpu_torch.examples.skeletal_bias_ab {biased|unbiased} [--device cpu]

Prints one JSON line (metric ``skeletal_bias_ab``, the JAX line's keys).
Knobs: ``MGR_TPU_AB_{FILES,MAXLEN,FPL,LABELS,SCALE,BATCH,LR1,LR2,EPOCHS1,
EPOCHS2,BIAS,ROOT,WORKDIR}``, the JAX script's names and defaults; ROOT
and WORKDIR default to directories under the temporary directory, and a
killed arm resumes from WORKDIR.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.data import datasets, synthetic
from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
from mgr_tpu_torch.examples import common
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train.loop import fit

METRIC = "skeletal_bias_ab"
ARMS = ("biased", "unbiased")


def _opt(lr: float) -> cfglib.OptimizerConfig:
    return cfglib.OptimizerConfig(learning_rate=lr, decay=1e-5, maxnorm=3.0,
                                  skip_nonfinite=100)


def main(arm: str = "unbiased", device: str = "cuda") -> dict:
    """Runs one arm on ``device``; prints and returns the JSON row."""
    if arm not in ARMS:
        raise ValueError(f"arm {arm!r}: choose from {ARMS}")
    common.resolve_device(device, "skeletal_bias_ab")
    env = os.environ.get
    bias = float(env("MGR_TPU_AB_BIAS", "-3") or 0) if arm == "biased" else 0.0
    files = int(env("MGR_TPU_AB_FILES", "40"))
    maxlen = int(env("MGR_TPU_AB_MAXLEN", "800"))
    fpl = int(env("MGR_TPU_AB_FPL", "90"))
    n_labels = int(env("MGR_TPU_AB_LABELS", "8"))
    scale = float(env("MGR_TPU_AB_SCALE", "0.08"))
    batch = int(env("MGR_TPU_AB_BATCH", "32"))
    lr1 = float(env("MGR_TPU_AB_LR1", "3e-3"))
    lr2 = float(env("MGR_TPU_AB_LR2", "3e-4"))
    epochs1 = int(env("MGR_TPU_AB_EPOCHS1", "2000"))
    epochs2 = int(env("MGR_TPU_AB_EPOCHS2", "1000"))
    root = env("MGR_TPU_AB_ROOT", os.path.join(tempfile.gettempdir(), "skel_ab_corpus"))
    workdir = env("MGR_TPU_AB_WORKDIR",
                  os.path.join(tempfile.gettempdir(), f"skel_ab_wd_{arm}"))

    os.makedirs(root, exist_ok=True)
    sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
        root, n_files=files, frames_per_label=fpl, max_labels=n_labels, seed=4, reuse=True)
    cfg = cfglib.get_preset("skeletal").replace(
        maxlen=maxlen, batch_size=batch,
        encoder=cfglib.EncoderConfig(
            hidden=max(4, int(300 * scale)), depth=2, input_noise=0.05,
            dropout=(0.02, 0.02), output_dropout=0.02, per_gate_dropout=True),
        optimizer=_opt(lr1),
        patience=10_000,
        head_blank_bias=bias,
    )
    ds = datasets.build_skeletal_dataset(sk_csv, sk_labels, cfg)

    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    fit(build_model(cfg, device=device), ds, workdir=workdir, resume=True,
        epochs=epochs1, checkpoint_every=100, monitor="train", sync_every=10)
    cfg2 = cfg.replace(optimizer=_opt(lr2))
    res = fit(build_model(cfg2, device=device), ds, workdir=workdir, resume=True,
              epochs=epochs1 + epochs2, checkpoint_every=100, monitor="train",
              keep_best_state=True, sync_every=10)
    wall = time.time() - t0

    model = build_model(cfg2, device=device)
    ckpt_lib.load_params(workdir, cfg2.name, model, slot="best")
    acc = evaluate_accuracy(model, ds, train_split=True)
    row = {
        "metric": METRIC,
        "arm": arm,
        "head_blank_bias": bias,
        "geometry": {"files": files, "maxlen": maxlen, "frames_per_label": fpl,
                     "max_labels": n_labels, "hidden_scale": scale},
        "train_accuracy": round(acc["accuracy"], 4),
        "train_wer": round(acc["wer"], 4),
        "best_train_loss": round(res.best_val_loss, 3),
        "wall_s": round(wall, 1),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    common.run_cli(main, __doc__.split("\n\n")[0],
                   positional={"name": "arm", "default": "unbiased", "choices": ARMS})
