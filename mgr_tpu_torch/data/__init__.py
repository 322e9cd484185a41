"""Corpus readers, vocabularies and batch assembly (``mgr_tpu/data``), and
the data preparation: the audio, skeletal, rgb and label pipelines and the
mixer."""
