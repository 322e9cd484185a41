"""Train / eval / predict / decode steps, the optimizer and the fit loop."""

from mgr_tpu_torch.train.optimizer import apply_maxnorm, keras_adam  # noqa: F401
from mgr_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_predict_step,
    make_train_step,
)
