"""towers_ms.decode: device time of the work charged to mgr.fusion.towers (late
fusion's two frozen encoders: their projections, K1 launches, residual sums
and casts), ms a call."""
from benchmark import spans


def read(record, events):
    return spans.work_ms(record, events, "mgr.fusion.towers")
