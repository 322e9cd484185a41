"""In-framework accuracy: decode a split and score it against the
dataset's own labels, with no MLF round trip
(``mgr_tpu/decode/evaluate.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.decode.decoder import DECODE_SPECS, Decoder, DecodeSpec
from mgr_tpu_torch.decode.scorer import score_sequences


def evaluate_accuracy(
    model,
    data: Batcher,
    *,
    pipeline: Optional[str] = None,
    train_split: bool = False,
    spec: Optional[DecodeSpec] = None,
    use_lengths: bool = False,
) -> Dict[str, float]:
    """Best-path-decode a split and return HTK-style corpus metrics
    (accuracy / corr / wer / sentence accuracy). Blanks are dropped from
    the hypotheses so they compare directly against the labels."""
    pipeline = pipeline or model.config.name
    s = spec or dataclasses.replace(DECODE_SPECS[pipeline], drop_blank=True)
    dec = Decoder.for_model(model, pipeline, s)

    refs: Dict[str, list] = {}
    batches = []
    for ids, batch in data.epoch(model.config.batch_size, train=train_split):
        for j, fid in enumerate(ids):
            n = int(batch["label_length"][j])
            refs[str(fid)] = batch["labels"][j, :n].tolist()
        batches.append((ids, batch))

    hyps = {
        str(fid): tokens
        for fid, tokens in dec.decode_batches(batches, use_lengths=use_lengths)
    }
    refs_tok = {k: [s.vocab[int(i)] for i in v] for k, v in refs.items()}
    metrics = score_sequences(refs_tok, hyps)
    if not refs:
        # Fewer files than one batch: remainder-drop yields no batch, so
        # the zeros mean "nothing scored", not "0% accurate".
        metrics["note"] = (
            "no full batch in this split (remainder-drop semantics); "
            "reduce batch_size to score it"
        )
    return metrics
