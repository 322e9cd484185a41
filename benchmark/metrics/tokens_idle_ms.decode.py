"""tokens_idle_ms.decode: device idle time while the host is inside
mgr.decode.tokens (the fetch of best/emit and the token extraction),
ms a call."""
from benchmark import spans


def read(record, events):
    return spans.idle_ms(record, events, "mgr.decode.tokens")
