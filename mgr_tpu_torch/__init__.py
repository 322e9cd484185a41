"""mgr_tpu_torch — the PyTorch / CUDA port of ``mgr_tpu``.

``mgr_tpu`` (JAX, Pallas kernels for the TPU) stays in the repository as
the reference; this package mirrors its layout so every module has a
counterpart of the same name:

  core      pipeline config and presets; named random streams (prng);
            checkpoints in the port's own format (``.pt``); JSONL metrics
  data      vocabularies, batch assembly, the corpus readers (numpy, no
            pandas; per-file audio CSVs through the C++ parser in
            ``native/``); data preparation: the audio, skeletal, rgb and
            label pipelines and the mixer; the synthetic fixtures
  ops       dispatch rule, BiLSTM recurrence, CTC loss (each with its
            adjoint), best-path decode; the featurizers (HTK MFCC,
            skeletal kinematics, ROI crop and resize)
  kernels   wrappers around the hand-written CUDA kernels (``csrc/``) and
            the autograd Functions that pair them
  models    dense head, residual BLSTM encoder, model zoo (train mode)
  train     train / eval / predict / decode steps, Keras-parity Adam, fit
  decode    MLF writer, scorer, decoder, in-framework evaluation
  cli       ``train`` / ``curriculum`` / ``infer`` / ``decode`` /
            ``evaluate`` / ``score`` / ``prepare-*`` / ``mix``
  utils     timer, tree helpers
  examples  ``synthetic_end_to_end``: corpus -> fit -> MLF -> score

The port imports ``torch`` and never ``jax``, and nothing of ``mgr_tpu``:
it stands alone on a machine that has only this package.

Every Pallas kernel on the train and serving paths has a hand-written
CUDA kernel (``csrc/*.cu``) beside a plain PyTorch version of the same
function. A tensor on the CPU goes to the plain version; a tensor on a
CUDA device goes to the kernel (``ops/dispatch.py``).
"""

__version__ = "0.1.0"

# The config module at the top level, as ``mgr_tpu.config``.
from mgr_tpu_torch.core import config  # noqa: E402,F401

__all__ = ["config", "__version__"]
