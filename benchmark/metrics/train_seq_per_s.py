"""train_seq_per_s: sequences whose optimizer step completed in the window,
over the window's seconds; the window ends in a synchronize (host clock)."""
from benchmark import readers


def read(record, events):
    return readers.per_second(record)
