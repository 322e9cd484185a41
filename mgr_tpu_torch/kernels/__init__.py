"""Wrappers of the hand-written CUDA kernels in ``mgr_tpu_torch/csrc``."""
