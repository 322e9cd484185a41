"""decode_seq_per_s: sequences decoded to tokens on the host in the window,
over the window's seconds (host clock)."""
from benchmark import readers


def read(record, events):
    return readers.per_second(record)
