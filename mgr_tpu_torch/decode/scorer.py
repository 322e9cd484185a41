"""In-framework sequence scoring (edit distance / HTK-style accuracy).

A copy of ``mgr_tpu/decode/scorer.py``: that package's ``__init__``
imports JAX, so the port carries its own.

The reference delegates scoring to the external HTK `HResults` tool on
its MLF outputs (SURVEY.md §4); this module removes that dependency.
HTK word accuracy = (N - S - D - I) / N where N is the number of
reference tokens and S/D/I are substitutions/deletions/insertions from
the minimum-edit-distance alignment.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Levenshtein alignment -> (distance, subs, dels, ins)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, S, D, I)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)  # deletions
    dp[0, :] = np.arange(m + 1)  # insertions
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # Backtrace to count S/D/I.
    i, j, S, D, I = n, m, 0, 0, 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            ref[i - 1] != hyp[j - 1]
        ):
            S += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            D += 1
            i -= 1
        else:
            I += 1
            j -= 1
    return int(dp[n, m]), int(S), int(D), int(I)


def score_sequences(
    refs: Dict[str, List], hyps: Dict[str, List], *, ignore_missing=False
) -> Dict[str, float]:
    """HTK-HResults-style corpus metrics over {utterance: token list}."""
    N = S = D = I = 0
    corr_sent = total_sent = 0
    for name, ref in refs.items():
        if name not in hyps:
            if ignore_missing:
                continue
            hyp: List = []
        else:
            hyp = hyps[name]
        _, s, d, ins = edit_distance(ref, hyp)
        N += len(ref)
        S += s
        D += d
        I += ins
        total_sent += 1
        corr_sent += int(list(ref) == list(hyp))
    if N == 0:
        return {"accuracy": 0.0, "wer": 0.0, "corr": 0.0,
                "sent_accuracy": 0.0, "N": 0}
    return {
        # HTK "Acc" = (N - S - D - I) / N ; can be negative.
        "accuracy": (N - S - D - I) / N,
        # HTK "Corr" = (N - S - D) / N.
        "corr": (N - S - D) / N,
        "wer": (S + D + I) / N,
        "sent_accuracy": corr_sent / max(total_sent, 1),
        "N": N,
    }
