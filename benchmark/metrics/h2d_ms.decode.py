"""h2d_ms.decode: device time of the host-to-device copies (the input
copy of train/step.py::batch_to_device / to_device), ms a call."""
from benchmark import readers


def read(record, events):
    return readers.h2d_ms(record, events)
