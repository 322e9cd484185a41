"""HTK Master Label File (MLF) writer/reader.

A copy of ``mgr_tpu/decode/mlf.py``: that package's ``__init__`` imports
JAX, so the port carries its own.

Byte-compatible with the reference's transcript outputs
(reference audio_network/sequence_decoding.py:34-65): a `#!MLF!#`
header, then per-utterance blocks of
    "*/<name>.rec"
    <token>
    ...
    .
Entry-name conventions per pipeline: speech uses `Sample#####_audio`
(sequence_decoding.py:60-62), the fusion/skeletal/rgb decoders use
`Sample#####` (multimodal_fusion/sequence_decoding.py:60-62).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence, Tuple


def entry_name(file_num: int, suffix: str = "") -> str:
    return f"Sample{int(file_num):05d}{suffix}"


def write_mlf(
    path: str | os.PathLike,
    entries: Iterable[Tuple[str, Sequence[str]]],
) -> None:
    """entries: iterable of (utterance_name, token list)."""
    with open(path, "w") as f:
        f.write("#!MLF!#\n")
        for name, tokens in entries:
            f.write(f'"*/{name}.rec"\n')
            for tok in tokens:
                f.write(f"{tok}\n")
            f.write(".\n")


def read_mlf(path: str | os.PathLike) -> Dict[str, List[str]]:
    """Parse an MLF back into {utterance_name: tokens}. Accepts both
    `.rec` and `.lab` entries; label lines may carry HTK time/score
    columns (token is the last whitespace field in the 1-3 column forms,
    the 3rd field in start/end/label forms)."""
    out: Dict[str, List[str]] = {}
    cur: List[str] = []
    name = None
    with open(path) as f:
        header = f.readline()
        if not header.startswith("#!MLF!#"):
            raise ValueError(f"{path} is not an MLF (missing #!MLF!# header)")
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith('"'):
                name = os.path.splitext(os.path.basename(line.strip('"')))[0]
                cur = []
                out[name] = cur
            elif line == ".":
                name = None
            else:
                fields = line.split()
                tok = fields[2] if len(fields) >= 3 else fields[-1]
                if name is not None:
                    cur.append(tok)
    return out
