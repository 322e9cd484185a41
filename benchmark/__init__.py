"""The benchmark of mgr_tpu_torch on the card (see benchmark/README.md)."""
