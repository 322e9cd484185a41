"""mfu.train_host: the model's matmul and convolution FLOPs for the work done in the
traced window (roofline.model_flops), over its seconds, against 989 TFLOP/s."""
from benchmark import readers


def read(record, events):
    return readers.mfu_pct(record, events)
