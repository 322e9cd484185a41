"""Host decode orchestration: predict -> best-path -> tokens -> MLF.

Counterpart of ``mgr_tpu/decode/decoder.py`` with the same per-pipeline
conventions:

  pipeline      threshold  MLF entry name
  speech        0.75       Sample#####_audio
  late_fusion   0.50       Sample#####
  early_fusion  0.97       Sample#####
  rgb           off        Sample#####
  skeletal      0.50       Sample#####
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mgr_tpu_torch.core import tracing
from mgr_tpu_torch.data import vocab as vocab_lib
from mgr_tpu_torch.decode import mlf as mlf_lib
from mgr_tpu_torch.ops.decoding import best_path_decode, emitted_sequences
from mgr_tpu_torch.train.step import batch_inputs, make_decode_step


@dataclass(frozen=True)
class DecodeSpec:
    threshold: float
    vocab: Dict[int, str]
    entry_suffix: str = ""
    trim_frames: int = 2
    collapse: bool = True
    drop_blank: bool = False  # the reference keeps blank as the "sil" token


DECODE_SPECS: Dict[str, DecodeSpec] = {
    "speech": DecodeSpec(0.75, vocab_lib.WORDS, entry_suffix="_audio"),
    "late_fusion": DecodeSpec(0.5, vocab_lib.GESTURE_CODES),
    "early_fusion": DecodeSpec(0.97, vocab_lib.GESTURE_CODES),
    "rgb": DecodeSpec(0.0, vocab_lib.GESTURE_CODES),
    "skeletal": DecodeSpec(0.5, vocab_lib.GESTURE_CODES),
}

MLF_FILENAMES: Dict[str, str] = {
    "speech": "ctc_recout.mlf",
    "late_fusion": "final_ctc_recout.mlf",
    "early_fusion": "final_ctc_recout.mlf",
    "rgb": "rgb_ctc_recout.mlf",
    "skeletal": "sk_ctc_recout.mlf",
}


def decode_probs(
    probs,
    spec: DecodeSpec,
    input_lengths=None,
) -> List[List[str]]:
    """(B, T, C) softmax probabilities -> token sequences, decoded on the
    probabilities' device."""
    probs = torch.as_tensor(probs)
    blank = probs.shape[-1] - 1 if spec.drop_blank else None
    best, emit = best_path_decode(
        probs,
        None if input_lengths is None
        else torch.as_tensor(input_lengths, device=probs.device),
        threshold=spec.threshold,
        trim_frames=spec.trim_frames,
        collapse=spec.collapse,
        blank=blank,
    )
    return [
        vocab_lib.ids_to_tokens(s, spec.vocab)
        for s in emitted_sequences(best, emit)
    ]


class Decoder:
    """Batched decoder for one pipeline, in one of two modes:

    * ``decode_fn(inputs, input_lengths|None) -> (best, emit)``: the fused
      on-device path (``train.step.make_decode_step``), where only the int
      argmax and the emit mask leave the device. ``for_model`` builds it.
    * ``predict_fn(inputs) -> (B, T, C)`` softmax posteriors, decoded by
      :func:`decode_probs` on whatever device they come back on.
    """

    def __init__(
        self,
        predict_fn: Optional[Callable[..., Any]] = None,
        pipeline: str = "speech",
        spec: Optional[DecodeSpec] = None,
        decode_fn: Optional[Callable[..., tuple]] = None,
    ):
        if predict_fn is None and decode_fn is None:
            raise ValueError("need predict_fn or decode_fn")
        self.predict_fn = predict_fn
        self.decode_fn = decode_fn
        self.pipeline = pipeline
        self.spec = spec or DECODE_SPECS[pipeline]

    def decode_batches(
        self,
        batches: Iterable[Tuple[Sequence[int], dict]],
        *,
        use_lengths: bool = False,
    ) -> List[Tuple[int, List[str]]]:
        """batches: iterable of (file_ids, batch_dict); a batch with
        ``inputs2`` hands the pair to the step. Returns
        [(file_id, tokens)] in input order. ``use_lengths`` masks decoding
        to the true sequence lengths instead of the padded length."""
        results: List[Tuple[int, List[str]]] = []
        for file_ids, batch in batches:
            lengths = np.asarray(batch["input_length"]) if use_lengths else None
            if self.decode_fn is not None:
                best, emit = self.decode_fn(batch_inputs(batch), lengths)
                with tracing.annotate("mgr.decode.tokens"):
                    seqs = [
                        vocab_lib.ids_to_tokens(s, self.spec.vocab)
                        for s in emitted_sequences(best, emit)
                    ]
            else:
                seqs = decode_probs(self.predict_fn(batch_inputs(batch)), self.spec, lengths)
            results.extend(zip(file_ids, seqs))
        return results

    @staticmethod
    def for_model(model, pipeline: str, spec: Optional[DecodeSpec] = None,
                  mesh=None) -> "Decoder":
        """A Decoder on the fused on-device decode step of ``model``;
        with a ``mesh`` (``parallel.mesh.Mesh``) each batch is decoded over
        its ranks (``make_decode_step(mesh=)``) and every rank gets the
        whole batch's sequences."""
        s = spec or DECODE_SPECS[pipeline]
        step = make_decode_step(
            model, threshold=s.threshold, trim_frames=s.trim_frames,
            drop_blank=s.drop_blank, mesh=mesh,
        )
        return Decoder(pipeline=pipeline, spec=s, decode_fn=step)

    def write_mlf(
        self,
        path: str,
        results: Sequence[Tuple[int, List[str]]],
        *,
        ignore_list: Sequence[int] = vocab_lib.DECODE_IGNORE_LIST,
    ) -> None:
        ignore = set(ignore_list)
        entries = [
            (mlf_lib.entry_name(fid, self.spec.entry_suffix), tokens)
            for fid, tokens in results
            if int(fid) not in ignore
        ]
        mlf_lib.write_mlf(path, entries)
