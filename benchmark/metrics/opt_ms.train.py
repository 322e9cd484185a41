"""opt_ms.train: device time from the first start to the last end of the work
launched in mgr.step.optimizer (freeze mask, global norm, Keras Adam, lr
scale, maxnorm, the in-place copy): its kernels and the idle between
them, ms a step."""
from benchmark import spans


def read(record, events):
    return spans.extent_ms(record, events, "mgr.step.optimizer")
