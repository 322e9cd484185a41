"""device_idle_pct.train: the share of the traced window covered by no kernel
or copy interval, %."""
from benchmark import readers


def read(record, events):
    return readers.idle_pct(record, events)
