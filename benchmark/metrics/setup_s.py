"""setup_s: seconds from process start to the first timed call: imports,
kernel build or load, weights, traffic, warm-up (host clock)."""


def read(record, events):
    return record["setup_s"]
