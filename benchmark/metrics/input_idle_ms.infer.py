"""input_idle_ms.infer: device idle time while the host is inside mgr.decode.input
(the inputs' and lengths' copy to the card), ms a request."""
from benchmark import spans


def read(record, events):
    return spans.idle_ms(record, events, "mgr.decode.input")
