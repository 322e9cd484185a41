"""Label vocabularies for the ChaLearn 2013 "Montalbano" gesture set
(a copy of ``mgr_tpu/data/vocab.py``).

Three id spaces, exactly as the reference uses them:
  * 22 gesture classes: 0 "oov", 1-20 gestures, 21 blank/"sil"
    (audio_network/data_generator.py:126-128).
  * 44 speech words: each gesture's Italian phrase split into words,
    0 "oov", 43 blank/"sil" (audio_network/sequence_decoding.py:24-29).
  * gesture NAME -> class id for the label files
    (skeletal_network/skeletal_feature_extraction.py:221-223).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

NUM_GESTURE_CLASSES = 22  # 0 oov, 1..20 gestures, 21 blank ("sil")
NUM_WORD_CLASSES = 44  # 0 oov, 1..42 words, 43 blank ("sil")

# Gesture class id -> short code used in the fusion/skeletal/rgb MLF
# outputs (multimodal_fusion/sequence_decoding.py:24-27).
GESTURE_CODES: Dict[int, str] = {
    0: "oov", 1: "VA", 2: "VQ", 3: "PF", 4: "FU", 5: "CP", 6: "CV",
    7: "DC", 8: "SP", 9: "CN", 10: "FN", 11: "OK", 12: "CF", 13: "BS",
    14: "PR", 15: "NU", 16: "FM", 17: "TT", 18: "BN", 19: "MC",
    20: "ST", 21: "sil",
}

# Word id -> Italian word used in the speech MLF output
# (audio_network/sequence_decoding.py:24-29). -1 also maps to "sil" there.
WORDS: Dict[int, str] = {
    0: "oov", 1: "Vattene", 2: "Vieni", 3: "qui", 4: "Perfetto", 5: "E'",
    6: "un", 7: "furbo", 8: "Che", 9: "due", 10: "palle", 11: "vuoi",
    12: "Vanno", 13: "d'accordo", 14: "Sei", 15: "Pazzo", 16: "Cos'hai",
    17: "combinato", 18: "Non", 19: "me", 20: "ne", 21: "frega",
    22: "niente", 23: "ok", 24: "Cosa", 25: "ti", 26: "farei", 27: "Basta",
    28: "Le", 29: "prendere", 30: "ce", 31: "n'e", 32: "piu", 33: "Ho",
    34: "fame", 35: "Tanto", 36: "tempo", 37: "fa", 38: "Buonissimo",
    39: "Si", 40: "sono", 41: "messi", 42: "stufo", 43: "sil", -1: "sil",
}

# Gesture class -> word-id sequence (the "sent_2_words" expansion,
# audio_network/data_generator.py:138-140). E.g. class 2 "vieniqui" ->
# words [2, 3] ("Vieni qui").
CLASS_TO_WORDS: Dict[int, List[int]] = {
    0: [0], 1: [1], 2: [2, 3], 3: [4], 4: [5, 6, 7], 5: [8, 9, 10],
    6: [8, 11], 7: [12, 13], 8: [14, 15], 9: [16, 17],
    10: [18, 19, 20, 21, 22], 11: [23], 12: [24, 25, 26], 13: [27],
    14: [28, 11, 29], 15: [18, 30, 31, 32], 16: [33, 34], 17: [35, 36, 37],
    18: [38], 19: [39, 40, 41, 13], 20: [40, 42], 21: [43],
}

# Gesture name (ChaLearn label files) -> class id
# (skeletal_feature_extraction.py:221-223).
GESTURE_NAME_TO_ID: Dict[str, int] = {
    "vattene": 1, "vieniqui": 2, "perfetto": 3, "furbo": 4,
    "cheduepalle": 5, "chevuoi": 6, "daccordo": 7, "seipazzo": 8,
    "combinato": 9, "freganiente": 10, "ok": 11, "cosatifarei": 12,
    "basta": 13, "prendere": 14, "noncenepiu": 15, "fame": 16,
    "tantotempo": 17, "buonissimo": 18, "messidaccordo": 19, "sonostufo": 20,
}

# Files the reference skips when writing MLF output
# (audio_network/sequence_decoding.py:32).
DECODE_IGNORE_LIST = (228, 298, 299, 300, 303, 304, 334, 343, 373, 375)


def class_seq_to_word_seq(class_seq: Sequence[int]) -> List[int]:
    """Expand a gesture-class sequence to the word-level label sequence."""
    out: List[int] = []
    for c in class_seq:
        out.extend(CLASS_TO_WORDS[int(c)])
    return out


def ids_to_tokens(ids: Sequence[int], table: Dict[int, str]) -> List[str]:
    return [table[int(i)] for i in ids]
