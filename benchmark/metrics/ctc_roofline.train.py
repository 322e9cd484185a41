"""ctc_roofline.train: K3 (with its alpha store) and K4 together, their least
time from each step's own label lengths over their device time, %."""
from benchmark import readers


def read(record, events):
    return readers.ctc_roofline_pct(record, events)
