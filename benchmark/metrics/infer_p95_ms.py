"""infer_p95_ms: 95th percentile (nearest rank) of every request of the
window, each from its send to its tokens on the host (host clock)."""
from benchmark import readers


def read(record, events):
    return readers.latency_ms(record, 0.95)
