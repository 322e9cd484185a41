"""Corpus decode: batches from a host pool in a seeded order through
``Decoder.decode_batches``, as ``decode`` and ``evaluate`` run them
(see ``benchmark/serving.py``). The batches are assembled at set-up and
cycled."""

import numpy as np

from benchmark.serving import ServeDriver


class Driver(ServeDriver):
    def prepare(self) -> None:
        T = self.cfg.maxlen
        self.batches = []
        for j in range(len(self.order) // self.B):
            rows = self.order[j * self.B:(j + 1) * self.B]
            self.batches.append((tuple(int(r) for r in rows), {
                "inputs": self.pool[rows],
                "input_length": np.full(self.B, T - self.trim, np.int32)}))

    def request(self, pos):
        return self.batches[pos % len(self.batches)]
