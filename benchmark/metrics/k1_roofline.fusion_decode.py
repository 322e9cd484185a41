"""k1_roofline.fusion_decode: K1 (lstm_fwd_kernel) in a late-fusion decode,
whose call launches K1 at three widths: each call's summed least time
(roofline.lstm_bound at the shape of each of its launches, the record's
``k1_launches``) times the calls the window's K1 launches make, over their
device time, %."""
from benchmark import readers, roofline, trace


def read(record, events):
    shapes = record.get("k1_launches")
    if events is None or not shapes:
        return None
    n, us = trace.kernel_time(events, readers.K1)
    if not n or not us:
        return None
    per_call_ms = sum(roofline.lstm_bound(s["T"], s["B"], s["H"], dirs=2, backward=False,
                                          store_c=False)["bound_ms"] for s in shapes)
    return 100.0 * n / len(shapes) * per_call_ms * 1e3 / us
