"""Decoder, MLF writer, scorer, in-framework evaluation."""

from mgr_tpu_torch.decode.decoder import Decoder, decode_probs  # noqa: F401
from mgr_tpu_torch.decode.mlf import read_mlf, write_mlf  # noqa: F401
from mgr_tpu_torch.decode.scorer import edit_distance, score_sequences  # noqa: F401
