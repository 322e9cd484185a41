"""Training traffic: the port's train step, driven as ``fit`` drives it.

Parameters (``benchmark/workloads/<cell>.json``):

  batch        sequences a step
  sequences    the corpus, made from the seed at set-up
  feed         "device_index": the corpus on the card, each step a (B,) row
               index uploaded and gathered by ``make_indexed_train_step``
               (``fit``'s device-resident path), rows in a seeded
               permutation each epoch;
               "host_batches": batches assembled at set-up in pageable host
               memory, as ``LazyVideoBatcher`` hands them, cycled, each
               copied by ``make_train_step``'s own ``batch_to_device``
  label_len    [lo, hi] labels a sequence, uniform
  label_ids    [lo, hi] label ids, uniform
  check_steps  steps taken at set-up through the window's own call, on rows
               that all differ, and followed by the reference

Every sequence is ``maxlen`` frames (the reference pads every sequence to
it, and CTC runs over the padding). Inputs: standard normal features, or
for a CNN configuration uint8 video normalised as (x - 128) / 255. Noise
and dropout draw from ``fold_in(fold_name(root_key(seed), "dropout"),
step)``, as ``fit`` folds them.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import harness, roofline
from benchmark.reference import prng as ref_prng

GRAD_FLOOR = 1e-3  # a leaf whose first gradient is under this share of the median leaf's


class Driver:
    span = "port.train_step"

    def __init__(self, run: harness.Run):
        self.run = run
        self.params = run.cell.params
        self.B = int(self.params["batch"])

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from mgr_tpu_torch.core import prng
        from mgr_tpu_torch.models.zoo import build_model
        from mgr_tpu_torch.train.step import (create_train_state, make_indexed_train_step,
                                              make_train_step)

        run, dev = self.run, self.run.device
        cfg = harness.pipeline_config(run.cell, batch_size=self.B)
        self.cfg = cfg
        marks = harness.Marks()
        model = build_model(cfg, device=dev)
        marks("build_model")
        weights = harness.make_weights({k: tuple(v.shape) for k, v in model.named_parameters()},
                                       run.seed, dev)
        harness.load_weights(model, weights)
        self.p0 = {k: v.detach().cpu().clone() for k, v in weights.items()}
        del weights
        marks("weights")
        self._make_corpus()
        marks("corpus")
        self.model = model
        self.state = create_train_state(model)
        self.indexed = self.params["feed"] == "device_index"
        self.step = make_indexed_train_step(model) if self.indexed else make_train_step(model)
        self._prng = prng
        self.key = prng.fold_name(prng.root_key(run.seed), "dropout")
        self.k = 0
        losses = []
        for i in range(int(self.params["check_steps"])):
            self.call()
            losses.append(self.metrics["loss"])
            if i == 0:  # Adam's first moment is (1 - b1) times the clipped gradient
                b1 = cfg.optimizer.beta1
                self.g1 = {k: (v / (1.0 - b1)).cpu().clone()
                           for k, v in self.state.opt_state.mu.items()}
        self.prog_losses = [float(x) for x in losses]
        self.p_after = {k: v.detach().cpu().clone() for k, v in self.state.params.items()}
        self.n_check = self.k
        marks("first_steps")
        self.setup_marks = marks.seconds

    def _make_corpus(self) -> None:
        cfg, p, seed, dev = self.cfg, self.params, self.run.seed, self.run.device
        n, T, trim = int(p["sequences"]), cfg.maxlen, cfg.ctc.trim_frames
        rng = np.random.default_rng(harness.sub_seed(seed, "labels"))
        lo, hi = p["label_len"]
        self.label_length = rng.integers(lo, hi + 1, size=n).astype(np.int32)
        ids = rng.integers(p["label_ids"][0], p["label_ids"][1] + 1,
                           size=(n, cfg.max_label_len)).astype(np.int32)
        labels = np.where(np.arange(cfg.max_label_len)[None] < self.label_length[:, None], ids, -1)
        host = {"labels": labels.astype(np.int32),
                "input_length": np.full(n, T - trim, np.int32),
                "label_length": self.label_length}
        gen = harness.generator(seed, "inputs", device=dev)
        if p["feed"] == "device_index":
            self.arrays = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            self.arrays["inputs"] = torch.randn((n, T, cfg.num_feats), generator=gen, device=dev)
            return
        d = cfg.cnn.img_dim
        video = torch.randint(0, 256, (n, T, d, d, 1), dtype=torch.uint8, generator=gen,
                              device=dev)
        order = np.random.default_rng(harness.sub_seed(seed, "order")).permutation(n)
        self.batches = []
        for j in range(n // self.B):
            rows = order[j * self.B:(j + 1) * self.B]
            x = video[torch.from_numpy(rows).to(dev)].float()
            x -= 128.0
            x /= 255.0
            batch = {k: v[rows] for k, v in host.items()}
            batch["inputs"] = x.cpu().numpy()
            self.batches.append(batch)
        del video

    def _rows(self, k: int) -> np.ndarray:
        n = int(self.params["sequences"])
        per_epoch = n // self.B
        epoch, j = divmod(k, per_epoch)
        if getattr(self, "_epoch", None) != epoch:
            self._epoch = epoch
            self._perm = np.random.default_rng(
                harness.sub_seed(self.run.seed, "epoch", epoch)).permutation(n)
        return self._perm[j * self.B:(j + 1) * self.B]

    # -- the window -------------------------------------------------------------

    def call(self) -> int:
        rng = self._prng.fold_in(self.key, self.k)
        if self.indexed:
            idx = torch.from_numpy(self._rows(self.k)).to(self.run.device)
            self.state, self.metrics = self.step(self.state, self.arrays, idx, rng)
        else:
            batch = self.batches[self.k % len(self.batches)]
            self.state, self.metrics = self.step(self.state, batch, rng)
        self.k += 1
        return self.B

    def _lengths(self, k: int) -> np.ndarray:
        if self.indexed:
            return self.label_length[self._rows(k)]
        return self.batches[k % len(self.batches)]["label_length"]

    def record(self) -> Dict[str, Any]:
        cfg = self.cfg
        T = cfg.maxlen - cfg.ctc.trim_frames
        return {
            "setup_marks": self.setup_marks,
            "flops_per_call": roofline.model_flops(self.run.cell.config["pipeline"], self.B,
                                                   train=True),
            "lstm": {"T": cfg.maxlen, "B": self.B, "H": cfg.encoder.hidden, "store_c": True},
            "ctc": {"T": T, "B": self.B, "K": cfg.nb_classes, "N": cfg.max_label_len,
                    "visits": [roofline.ctc_visits([T] * self.B, self._lengths(k))
                               for k in range(self.n_check, self.k)]},
        }

    # -- the check --------------------------------------------------------------

    def _check_batches(self) -> List[Dict[str, torch.Tensor]]:
        dev = self.run.device
        if self.indexed:
            return [{k: v[torch.from_numpy(self._rows(i)).to(dev)] for k, v in self.arrays.items()}
                    for i in range(self.n_check)]
        return [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}
                for b in self.batches[:self.n_check]]

    def check(self, substitute: Optional[str] = None):
        """Loss of each set-up step, the first gradient as Adam takes it, and
        the parameters' change over the set-up steps, against the plain
        reference following the same steps from the same weights."""
        batches = self._check_batches()
        keys = [ref_prng.Key(int(self.run.seed), ("dropout", i)) for i in range(self.n_check)]
        for name in ("state", "step", "model", "metrics", "arrays", "batches"):
            self.__dict__.pop(name, None)
        harness.free_device()
        ref_mod = self.run.reference()
        pipeline, dev = self.run.cell.config["pipeline"], self.run.device
        ref = ref_mod.Reference(pipeline, self.p0, dev)
        ref_losses, ref_g1 = ref.train(batches, keys)
        ref_after = {k: v.cpu() for k, v in ref.p.items()}
        del ref
        if substitute == "control":
            ctl = ref_mod.Reference(pipeline, self.p0, dev, precision="fp8")
            losses, g1 = ctl.train(batches, keys)
            after = {k: v.cpu() for k, v in ctl.p.items()}
            del ctl
        else:
            losses, g1, after = self.prog_losses, self.g1, self.p_after
        harness.free_device()
        return compare_training(losses, g1, after, ref_losses, ref_g1, ref_after, self.p0,
                                self.run.cell.limits), 0


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double().cpu()))
            for k, v in tensors.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names: List[str]):
    """The widest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; and that leaf's name."""
    med = statistics.median(ref[k] for k in names)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in names)


def compare_training(losses, g1, after, ref_losses, ref_g1, ref_after, p0,
                     limits: Dict[str, float]) -> List[Dict[str, Any]]:
    names = sorted(ref_g1)
    ref_gn = _norms(ref_g1)
    med = statistics.median(ref_gn.values())
    moved = [k for k in names if ref_gn[k] >= GRAD_FLOOR * med]
    change = _norms({k: after[k].double() - p0[k].double() for k in names})
    ref_change = _norms({k: ref_after[k].double() - p0[k].double() for k in names})
    grad_gap, grad_at = worst_leaf(_norms(g1), ref_gn, names)
    change_gap, change_at = worst_leaf(change, ref_change, moved)
    return [
        {"name": "loss_gap", "value": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
         "limit": limits.get("loss_gap")},
        {"name": "grad_gap", "value": grad_gap, "limit": limits.get("grad_gap"), "at": grad_at},
        {"name": "change_gap", "value": change_gap, "limit": limits.get("change_gap"),
         "at": change_at},
        {"name": "leaves_left_out", "value": len(names) - len(moved), "limit": None},
    ]
