"""fuse_ms.decode: device time of the work charged to mgr.fusion.layer (late
fusion's concat of the towers' streams and its fusion BiLSTM: the projection
over 1,600 features and one K1 launch at H=100), ms a call."""
from benchmark import spans


def read(record, events):
    return spans.work_ms(record, events, "mgr.fusion.layer")
