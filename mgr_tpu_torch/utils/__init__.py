"""Small shared utilities: tree helpers over nested dicts of tensors, a
timer (``mgr_tpu/utils``)."""

from mgr_tpu_torch.utils.timing import Timer  # noqa: F401
from mgr_tpu_torch.utils.trees import tree_count_params, tree_norm  # noqa: F401
