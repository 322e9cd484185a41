"""Matmul FLOPs of the late-fusion model (``configs/late_fusion.json``),
counted as ``roofline.model_flops`` counts a BLSTM-CTC pipeline's: each
BiLSTM layer's two input projections and two recurrences (one (B,H)x(H,4H)
product a step and direction), and the head; elementwise work and CTC are
not counted.

Forward: both towers at their own sources' widths and depths (speech over
39 features, skeletal over 20), the fusion layer's projection over their
concat (2 H_speech + 2 H_skeletal features) and its recurrence at
``fusion_hidden``, and the head over 2 ``fusion_hidden``. Training (frozen
towers): the towers' forward once, and the fusion layer and head forward
and backward (twice the forward), less the fusion projection's input
gradient, which nothing upstream needs.

``k1_launches`` gives the shape of each K1 launch of one forward, in
launch order, for the K1 roofline at mixed widths.
"""

from __future__ import annotations

from typing import Any, Dict, List


def _bilstm(frames: float, F: int, H: int) -> Dict[str, float]:
    return {"proj": 2 * 2.0 * frames * F * 4 * H, "rec": 2 * 2.0 * frames * H * 4 * H}


def _tower(frames: float, source: Dict[str, Any]) -> float:
    enc, F, total = source["encoder"], source["num_feats"], 0.0
    for _ in range(enc["depth"]):
        total += sum(_bilstm(frames, F, enc["hidden"]).values())
        F = 2 * enc["hidden"]
    return total


def late_fusion_flops(config: Dict[str, Any], B: int, *, train: bool) -> float:
    """FLOPs of one forward (``train``: one train step) over B sequences of
    ``maxlen`` frames; ``config`` is the configuration file's dict
    (``pipeline`` and ``sources``)."""
    pipe, sources = config["pipeline"], config["sources"]
    frames = pipe["maxlen"] * B
    towers = sum(_tower(frames, sources[name]) for name in ("speech", "skeletal"))
    concat = sum(2 * sources[name]["encoder"]["hidden"] for name in ("speech", "skeletal"))
    Hf = pipe["fusion_hidden"]
    fusion = _bilstm(frames, concat, Hf)
    trained = fusion["proj"] + fusion["rec"] + 2.0 * frames * 2 * Hf * pipe["nb_classes"]
    if not train:
        return towers + trained
    return towers + 3 * trained - fusion["proj"]


def k1_launches(config: Dict[str, Any], B: int) -> List[Dict[str, int]]:
    """(T, B, H) of each bidirectional K1 launch of one forward: one a tower
    layer (speech, then skeletal), then the fusion layer."""
    pipe, sources = config["pipeline"], config["sources"]
    hidden = [sources[name]["encoder"]["hidden"] for name in ("speech", "skeletal")
              for _ in range(sources[name]["encoder"]["depth"])]
    return [{"T": pipe["maxlen"], "B": B, "H": H} for H in hidden + [pipe["fusion_hidden"]]]
