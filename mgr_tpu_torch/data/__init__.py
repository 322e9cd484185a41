"""Corpus readers, vocabularies and batch assembly (``mgr_tpu/data``)."""
