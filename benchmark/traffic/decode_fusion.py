"""Late-fusion corpus decode: pairs of utterances, 39 MFCC and 20 kinematic
features a frame, from two seeded host pools in a seeded order, through
``Decoder.for_model(model, "late_fusion").decode_batches``, as ``decode``
and ``evaluate`` run a fusion corpus: each batch carries ``inputs`` and
``inputs2`` and the decode step gets the pair (``train.step.batch_inputs``).
The batches are assembled at set-up and cycled.

The model is ``build_model`` of the configuration file's ``pipeline``,
its towers built from the file's ``sources``. Parameters, the sampling and
the check are ``serving.py``'s; ``flops_per_call`` is the late-fusion
count of ``fusion_flops.py``, and ``k1_launches`` the shape of each K1
launch of a call.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from benchmark import fusion_flops, harness
from benchmark.serving import REF_ROWS, ServeDriver, compare_decode, reference_decode


def source_configs(cell: harness.Cell):
    """The port's PipelineConfig of each tower's source pipeline."""
    from mgr_tpu_torch.core.config import PipelineConfig

    return {name: PipelineConfig.from_json(json.dumps(raw))
            for name, raw in cell.config["sources"].items()}


class Driver(ServeDriver):
    def setup(self) -> None:
        from mgr_tpu_torch.decode.decoder import Decoder
        from mgr_tpu_torch.models.zoo import build_model

        run, dev, p = self.run, self.run.device, self.params
        cfg = harness.pipeline_config(run.cell, batch_size=self.B)
        self.cfg = cfg
        marks = harness.Marks()
        model = build_model(cfg, source_configs(run.cell), device=dev)
        marks("build_model")
        weights = harness.make_weights({k: tuple(v.shape) for k, v in model.named_parameters()},
                                       run.seed, dev, scales={"head.W": float(p["head_scale"])})
        harness.load_weights(model, weights)
        self.p0 = {k: v.detach().cpu().clone() for k, v in weights.items()}
        del weights
        marks("weights")
        n, T = int(p["pool"]), cfg.maxlen
        self.trim = cfg.ctc.trim_frames
        self.pools = tuple(
            torch.randn((n, T, feats), device=dev,
                        generator=harness.generator(run.seed, name, device=dev)).cpu().numpy()
            for name, feats in (("pool", cfg.num_feats), ("pool2", cfg.second_stream_feats)))
        self.order = np.random.default_rng(harness.sub_seed(run.seed, "order")).permutation(n)
        self.batches = []
        for j in range(n // self.B):
            rows = self.order[j * self.B:(j + 1) * self.B]
            self.batches.append((tuple(int(r) for r in rows), {
                "inputs": self.pools[0][rows], "inputs2": self.pools[1][rows],
                "input_length": np.full(self.B, T - self.trim, np.int32)}))
        marks("pool")
        self.model = model
        self.decoder = Decoder.for_model(model, cfg.name)
        decode_fn = self.decoder.decode_fn

        def caught(inputs, lengths):
            best, emit = decode_fn(inputs, lengths)
            if self.sampling:
                self.last = (best, emit)
            return best, emit

        self.decoder.decode_fn = caught
        self.sampling, self.pos, self.failed = False, 0, 0
        self.captured = {}
        for _ in range(int(p["warmup"])):
            self.call()
        self.pos, self.failed = 0, 0
        self.captured.clear()
        marks("warmup")
        self.setup_marks = marks.seconds

    def request(self, pos):
        return self.batches[pos % len(self.batches)]

    def record(self) -> Dict[str, Any]:
        config = self.run.cell.config
        return {"setup_marks": self.setup_marks,
                "flops_per_call": fusion_flops.late_fusion_flops(config, self.B, train=False),
                "k1_launches": fusion_flops.k1_launches(config, self.B)}

    def check(self, substitute: Optional[str] = None):
        """The sampled calls' rows (a seeded choice, ``check_rows`` of them)
        against the reference, given both streams of each row."""
        rng = np.random.default_rng(harness.sub_seed(self.run.seed, "check"))
        rows, best, emit, tokens = [], [], [], []
        for pos in rng.permutation(sorted(self.captured)):
            ids, (b, e), toks = self.captured[int(pos)]
            rows += list(ids)
            best.append(b.cpu().numpy())
            emit.append(e.cpu().numpy())
            tokens += toks
            if len(rows) >= int(self.params["check_rows"]):
                break
        for name in ("decoder", "model", "captured", "last", "batches"):
            self.__dict__.pop(name, None)
        harness.free_device()
        if not rows:
            return [{"name": "class_gap", "value": float("nan"), "limit": 0.0}], self.failed
        best, emit = np.concatenate(best), np.concatenate(emit)
        dec, config = self.run.cell.config["decode"], self.run.cell.config
        ref_mod, dev = self.run.reference(), self.run.device

        def reference(precision):
            return ref_mod.Reference(config["pipeline"], self.p0, dev, precision,
                                     sources=config["sources"])

        lp = log_probs(reference("f32"), self.pools, rows)
        if substitute == "control":
            best, emit = reference_decode(log_probs(reference("fp8"), self.pools, rows),
                                          dec["threshold"])
            tokens = [[dec["tokens"][c] for c in b[e]] for b, e in zip(best, emit)]
        harness.free_device()
        return compare_decode(best, emit, tokens, lp, dec, self.run.cell.limits), self.failed


def log_probs(ref, pools, rows) -> np.ndarray:
    """The reference's (N, T', C) log-posteriors of the pairs ``rows`` of
    ``pools``, REF_ROWS rows at a time."""
    out = [ref.log_probs(tuple(torch.from_numpy(p[rows[a:a + REF_ROWS]]) for p in pools))
           .cpu().numpy() for a in range(0, len(rows), REF_ROWS)]
    return np.concatenate(out)
