"""proj_ms.train: device time of the work charged to mgr.lstm.projection, its forward
and (by the sequence-number link) its backward: the GEMMs, the f32 bias
add, the casts and their gradients, ms a step."""
from benchmark import spans


def read(record, events):
    return spans.work_ms(record, events, "mgr.lstm.projection")
