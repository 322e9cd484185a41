"""Dispatch rule, BiLSTM recurrence, CTC loss, best-path decoding, and the
featurizers (MFCC, kinematics, ROI crop and resize)."""
