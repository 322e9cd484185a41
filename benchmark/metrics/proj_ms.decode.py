"""proj_ms.decode: device time of the work charged to mgr.lstm.projection (the
GEMMs, the f32 bias add and the casts; no backward), ms a call."""
from benchmark import spans


def read(record, events):
    return spans.work_ms(record, events, "mgr.lstm.projection")
