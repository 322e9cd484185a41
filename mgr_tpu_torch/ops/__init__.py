"""Dispatch rule, BiLSTM recurrence, CTC loss, best-path decoding."""
