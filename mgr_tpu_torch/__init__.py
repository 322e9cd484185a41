"""mgr_tpu_torch — the PyTorch / CUDA port of ``mgr_tpu``.

``mgr_tpu`` (JAX, Pallas kernels for the TPU) stays in the repository as
the reference; this package mirrors its layout so every module has a
counterpart of the same name:

  core      pipeline config and presets; checkpoints in the port's own
            format (``params.pt``)
  data      vocabularies, batch assembly, speech and skeletal corpus
            readers (numpy, no pandas)
  ops       dispatch rule, BiLSTM recurrence, CTC loss, best-path decode
  kernels   wrappers around the hand-written CUDA kernels (``csrc/``)
  models    dense head, residual BLSTM encoder, model zoo
  train     eval / predict / decode steps (the serving path)
  decode    MLF writer, scorer, decoder, in-framework evaluation
  cli       ``infer`` / ``decode`` / ``evaluate`` / ``score``

The port imports ``torch`` and never ``jax``, and nothing of ``mgr_tpu``:
it stands alone on a machine that has only this package.

Every Pallas kernel on the serving path has a hand-written CUDA kernel
(``csrc/*.cu``) beside a plain PyTorch version of the same function. A
tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel (``ops/dispatch.py``).
"""

__version__ = "0.1.0"
