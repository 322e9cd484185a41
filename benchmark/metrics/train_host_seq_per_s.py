"""train_host_seq_per_s: as train_seq_per_s, for cells whose batches come
from host memory and are copied every step; those runs spread tenfold
wider on a shared host, so they carry a bound of their own (host clock)."""
from benchmark import readers


def read(record, events):
    return readers.per_second(record)
