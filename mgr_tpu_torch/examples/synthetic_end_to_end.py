"""End-to-end walkthrough on synthetic ChaLearn-format data
(``examples/synthetic_end_to_end.py`` of the JAX package).

Generates a toy corpus in the reference's on-disk layout, trains the
skeletal pipeline, decodes the validation split to an HTK MLF and scores
it, then scores the train split in-framework: the whole train -> decode
-> score loop, no dataset needed.

    python -m mgr_tpu_torch.examples.synthetic_end_to_end [workdir] [--device cpu]

It runs on the first card (through the kernels) unless ``--device cpu``
asks for the plain versions on the CPU. ``MGR_TPU_EXAMPLE_EPOCHS`` sets
the epochs (default 300). At these defaults (input noise and dropout
0.1) the model decodes only the blank; :func:`example_config` with
``noise=0.0, dropout=0.0`` is the configuration that learns the corpus.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

from mgr_tpu_torch.core import config as cfglib
from mgr_tpu_torch.data import datasets, synthetic, vocab
from mgr_tpu_torch.decode import Decoder, mlf, read_mlf, score_sequences
from mgr_tpu_torch.decode.decoder import MLF_FILENAMES
from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
from mgr_tpu_torch.examples import common
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train.loop import fit


def make_corpus(workdir: str):
    """The example's corpus: a monolithic skeletal CSV (20 kinematic
    features + file_number) and an Id,Sequence label CSV. Returns
    (csv_path, label_file, labels)."""
    os.makedirs(workdir, exist_ok=True)
    return synthetic.make_skeletal_dataset(
        workdir, n_files=8, frames_per_label=25, max_labels=2, seed=4)


def example_config(noise: float = 0.1, dropout: float = 0.1) -> cfglib.PipelineConfig:
    """The skeletal preset cut to the toy corpus: maxlen 64, B=2, f32,
    BiLSTM(16)x2, lr 1e-2, patience 1000, CTC on the true lengths."""
    return cfglib.get_preset("skeletal").replace(
        maxlen=64, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=16, depth=2, input_noise=noise,
                                     dropout=(dropout, dropout),
                                     output_dropout=dropout),
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-2),
        patience=1000,
        ctc=cfglib.CTCConfig(padded_length_parity=False),
    )


def main(workdir: Optional[str] = None, device: str = "cuda") -> dict:
    """Runs the walkthrough in ``workdir`` (default a new temporary
    directory) on ``device``; returns the MLF metrics, the train-split
    accuracy and the epochs run."""
    workdir = workdir or tempfile.mkdtemp(prefix="mgr_tpu_torch_example_")
    print(f"workdir: {workdir}")

    # 1) Synthetic corpus in the reference's format.
    csv_path, label_file, labels = make_corpus(workdir)

    # 2) A scaled-down skeletal preset (the full preset's 1900-frame /
    #    BiLSTM(300) geometry is overkill for a toy corpus).
    cfg = example_config()
    data = datasets.build_skeletal_dataset(csv_path, label_file, cfg)

    # 3) Train (early stopping, best/latest checkpoints, metrics JSONL).
    model = build_model(cfg, device=device)
    epochs = int(os.environ.get("MGR_TPU_EXAMPLE_EPOCHS", "300"))
    result = fit(model, data, workdir=workdir, epochs=epochs)
    print(f"trained {result.epochs_run} epochs, "
          f"best val loss {result.best_val_loss:.3f}")

    # 4) Decode the validation split to an HTK MLF.
    dec = Decoder.for_model(model, "skeletal")
    decoded = dec.decode_batches(
        data.epoch(cfg.batch_size, train=False), use_lengths=True)
    mlf_path = os.path.join(workdir, MLF_FILENAMES["skeletal"])
    dec.write_mlf(mlf_path, decoded)
    print(f"wrote {mlf_path}")

    # 5) Score against ground truth, both via MLFs and in-framework.
    refs_path = os.path.join(workdir, "refs.mlf")
    mlf.write_mlf(refs_path, [
        (mlf.entry_name(fid), [vocab.GESTURE_CODES[c] for c in seq])
        for fid, seq in labels.items()
    ])
    metrics = score_sequences(read_mlf(refs_path), read_mlf(mlf_path),
                              ignore_missing=True)
    print("MLF scoring:", json.dumps(metrics))
    accuracy = evaluate_accuracy(model, data, train_split=True, use_lengths=True)
    print("in-framework train-split accuracy:", json.dumps(accuracy))
    return {"mlf": metrics, "accuracy": accuracy, "epochs": result.epochs_run}


if __name__ == "__main__":
    common.run_cli(main, __doc__.split("\n\n")[0],
                   positional={"name": "workdir", "default": None})
