"""cnn_ms.train_host: device time of the work charged to mgr.cnn.frontend: its
forward, the remat recompute inside the backward, and (by the
sequence-number link) its backward, ms a step."""
from benchmark import spans


def read(record, events):
    return spans.work_ms(record, events, "mgr.cnn.frontend")
