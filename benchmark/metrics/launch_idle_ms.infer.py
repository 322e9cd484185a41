"""launch_idle_ms.infer: device idle time while the host is inside
mgr.decode.forward (the model, softmax and best path enqueued; the spans
inside it included), ms a request."""
from benchmark import spans


def read(record, events):
    return spans.idle_ms(record, events, "mgr.decode.forward")
