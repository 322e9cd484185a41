"""Decode traffic, shared by the ``decode`` and ``infer`` kinds: utterances
from a seeded host pool through one ``Decoder.for_model`` built at
set-up, ``decode_batches`` a call, its tokens on the host when it returns
(one client, closed loop). A kind's ``Driver`` says what a call sends
(``request``): ``decode`` cycles batches assembled at set-up, ``infer``
pads one utterance a call as ``infer`` pads it.

Parameters (``benchmark/workloads/<cell>.json``):

  batch         utterances a call
  pool          utterances made from the seed at set-up, kept on the host
  head_scale    the head's kernel is drawn this many times wider than the
                other kernels, so that a share of the frames clears the
                decode threshold and the window emits tokens
  warmup        calls before the window
  sample_every  a call is sampled for the check with this odds (by the seed)
  check_rows    rows of the sampled calls that the reference compares

The check: the decode's per-frame classes (``best``) and emit mask, caught
at the decode step's output for the sampled calls, and the tokens that
reached the host, against the reference's float32 log-posteriors of the
same utterances (see ``compare_decode``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import harness, roofline

EMIT_MARGIN = 0.05  # probability: an emission decision this close to the threshold may flip
REF_ROWS = 64       # rows the reference runs at once


class ServeDriver:
    span = "port.decode_batches"

    def __init__(self, run: harness.Run):
        self.run = run
        self.params = run.cell.params
        self.B = int(self.params["batch"])

    def setup(self) -> None:
        from mgr_tpu_torch.decode.decoder import Decoder
        from mgr_tpu_torch.models.zoo import build_model

        run, dev, p = self.run, self.run.device, self.params
        cfg = harness.pipeline_config(run.cell, batch_size=self.B)
        self.cfg = cfg
        marks = harness.Marks()
        model = build_model(cfg, device=dev)
        marks("build_model")
        weights = harness.make_weights({k: tuple(v.shape) for k, v in model.named_parameters()},
                                       run.seed, dev, scales={"head.W": float(p["head_scale"])})
        harness.load_weights(model, weights)
        self.p0 = {k: v.detach().cpu().clone() for k, v in weights.items()}
        del weights
        marks("weights")
        n, T = int(p["pool"]), cfg.maxlen
        self.trim = cfg.ctc.trim_frames
        self.pool = torch.randn((n, T, cfg.num_feats), device=dev,
                                generator=harness.generator(run.seed, "pool", device=dev)
                                ).cpu().numpy()
        self.order = np.random.default_rng(harness.sub_seed(run.seed, "order")).permutation(n)
        self.prepare()
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
        self.captured: Dict[int, Tuple] = {}
        for _ in range(int(p["warmup"])):
            self.call()
        self.pos, self.failed = 0, 0
        self.captured.clear()
        marks("warmup")
        self.setup_marks = marks.seconds

    def prepare(self) -> None:
        """What the kind assembles from the pool at set-up."""

    def request(self, pos: int) -> Tuple[Tuple[int, ...], Dict[str, np.ndarray]]:
        """The ``pos``-th call's (pool rows, batch)."""
        raise NotImplementedError

    def _sampled(self, pos: int) -> bool:
        every = int(self.params["sample_every"])
        return harness.sub_seed(self.run.seed, "sample", pos) % every == 0

    def call(self) -> int:
        ids, batch = self.request(self.pos)
        self.sampling = self._sampled(self.pos)
        out = self.decoder.decode_batches([(ids, batch)])
        self.failed += len(ids) - len(out)
        if self.sampling:
            self.captured[self.pos] = (ids, self.last, [tokens for _, tokens in out])
        self.pos += 1
        return len(out)

    def record(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"setup_marks": self.setup_marks,
                "flops_per_call": roofline.model_flops(self.run.cell.config["pipeline"], self.B,
                                                       train=False),
                "lstm": {"T": cfg.maxlen, "B": self.B, "H": cfg.encoder.hidden,
                         "store_c": False}}

    def check(self, substitute: Optional[str] = None):
        """The sampled calls' rows (a seeded choice, ``check_rows`` of them)
        against the reference."""
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
        for name in ("decoder", "model", "captured", "last"):
            self.__dict__.pop(name, None)
        harness.free_device()
        if not rows:
            return [{"name": "class_gap", "value": float("nan"), "limit": 0.0}], self.failed
        best, emit = np.concatenate(best), np.concatenate(emit)
        dec = self.run.cell.config["decode"]
        ref_mod = self.run.reference()
        pipeline, dev = self.run.cell.config["pipeline"], self.run.device
        lp = log_probs(ref_mod.Reference(pipeline, self.p0, dev), self.pool[rows])
        if substitute == "control":
            ctl = log_probs(ref_mod.Reference(pipeline, self.p0, dev, precision="fp8"),
                            self.pool[rows])
            best, emit = reference_decode(ctl, dec["threshold"])
            tokens = [[dec["tokens"][c] for c in b[e]] for b, e in zip(best, emit)]
        harness.free_device()
        return compare_decode(best, emit, tokens, lp, dec, self.run.cell.limits), self.failed


def log_probs(ref, x: np.ndarray) -> np.ndarray:
    """The reference's (N, T', C) log-posteriors, REF_ROWS rows at a time."""
    out = [ref.log_probs(torch.from_numpy(x[a:a + REF_ROWS])).cpu().numpy()
           for a in range(0, len(x), REF_ROWS)]
    return np.concatenate(out)


def reference_decode(lp: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Best path: a frame's class is its argmax; it is emitted when its
    probability reaches the threshold and its class differs from that of
    the last frame that did."""
    best = lp.argmax(-1)
    valid = np.exp(lp.max(-1)) >= threshold
    return best, _collapse(best, valid)


def _collapse(best: np.ndarray, valid: np.ndarray) -> np.ndarray:
    emit = np.zeros_like(valid)
    for r in range(best.shape[0]):
        prev = None
        for t in np.flatnonzero(valid[r]):
            emit[r, t] = prev is None or best[r, t] != best[r, prev]
            prev = t
    return emit


def compare_decode(best: np.ndarray, emit: np.ndarray, tokens: List[List[str]],
                   lp: np.ndarray, dec: Dict[str, Any],
                   limits: Dict[str, float]) -> List[Dict[str, Any]]:
    """``class_gap``: the widest gap by which a frame's class lies below the
    reference's best class, in log-probability. ``emit_off``: frames whose
    emit is not the one that the program's classes give, a frame valid
    where the reference's probability reaches the threshold; where that
    probability lies within EMIT_MARGIN of the threshold the program's own
    emit stands for its validity (a frame it does not emit read as
    invalid: were it a valid repeat instead, the same frames would
    follow). ``token_off``: rows whose tokens on the host are not the
    tokens of their emitted frames. Printed, not compared: ``emitted``,
    the tokens of the compared rows, and ``emit_near``, how far below the
    threshold the reference puts a frame that the program emitted."""
    chosen = np.take_along_axis(lp, best[..., None].astype(np.int64), -1)[..., 0]
    class_gap = float((lp.max(-1) - chosen).max())
    conf = np.exp(lp.max(-1))
    clear = np.abs(conf - dec["threshold"]) > EMIT_MARGIN
    expected = _collapse(best, np.where(clear, conf >= dec["threshold"], emit))
    emit_off = int((expected != emit).sum())
    table = dec["tokens"]
    token_off = sum(list(t) != [table[c] for c in b[e]] for b, e, t in zip(best, emit, tokens))
    values = {"class_gap": class_gap, "emit_off": emit_off, "token_off": int(token_off)}
    out = [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]
    near = float((dec["threshold"] - conf[emit.astype(bool)]).max(initial=0.0))
    return out + [{"name": "emitted", "value": int(emit.sum()), "limit": None},
                  {"name": "emit_near", "value": max(near, 0.0), "limit": None}]
