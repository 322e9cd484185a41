"""k1_roofline.train_host: K1 (lstm_fwd_kernel) launches' summed least time
(roofline.lstm_bound at the cell's shape) over their device time, %."""
from benchmark import readers


def read(record, events):
    return readers.lstm_roofline_pct(record, events, backward=False)
