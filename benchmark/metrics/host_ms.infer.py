"""host_ms.infer: per request, the span around decode_batches less the
device's busy time inside it, ms (mean over the traced window)."""
from benchmark import readers


def read(record, events):
    return readers.host_ms(record, events, "port.decode_batches")
