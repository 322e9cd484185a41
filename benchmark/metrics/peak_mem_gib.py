"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""
from benchmark import readers


def read(record, events):
    peak = record["memory_peak_bytes"]
    return peak / readers.GIB if peak else None
