"""Single-utterance serving: one client, closed loop, each request one
utterance padded as ``infer`` pads it (``data.batcher.pad_or_truncate``)
when it is sent, and decoded by ``decode_batches`` (see
``benchmark/serving.py``)."""

import numpy as np

from benchmark.serving import ServeDriver


class Driver(ServeDriver):
    def prepare(self) -> None:
        from mgr_tpu_torch.data.batcher import pad_or_truncate

        self.pad = pad_or_truncate

    def request(self, pos):
        row = int(self.order[pos % len(self.order)])
        padded, true_len = self.pad(self.pool[row], self.cfg.maxlen)
        return (row,), {"inputs": padded[None],
                        "input_length": np.asarray([true_len - self.trim], np.int32)}
