"""Plain PyTorch reference of the reference repository's late multimodal
fusion (``multimodal_fusion/multimodal.py:58-215``), in float32 with TF32
off.

The model, from a configuration file's ``pipeline`` and the two source
pipelines its towers are built from (``sources``): a speech tower over
(B, T, 39) MFCC and a skeletal tower over (B, T, 20) kinematic features,
each ``depth`` BiLSTM layers (Keras-2 LSTM, ``hard_sigmoid`` on i, f, o)
with the residual sum of its last two layers; the concat of their
residual streams, speech first (1000 + 600 features); a BiLSTM of width
``fusion_hidden`` with input dropout ``fusion_dropout``; dropout
``fusion_output_dropout``; Dense to the classes; CTC (blank = classes - 1)
after the first ``trim_frames`` frames.

In train mode (a key) every draw comes from ``benchmark.reference.prng``
on the key paths the port's ``LateFusionModel.apply_tm`` folds: the
speech tower under ``enc_a`` (its noise ``pipeline.encoder.input_noise``
from ``noise``, layer i's input dropout at the speech source's rate from
``drop_i``, one (B, F) mask a direction from ``fold_in(., d)``), the
skeletal tower under ``enc_s`` (noise ``second_stream_noise``, the
skeletal source's dropout rates), the fusion layer's input dropout from
``fusion_drop`` and the head's dropout from ``head_drop``.

``train`` takes Keras-Adam steps (element-wise clip, bias correction,
inverse-time decay) over ``fusion.*`` and ``head.*`` only: the towers are
frozen and their parameters never change. maxnorm follows the port's rule
(``train/optimizer.py::is_constrained_kernel``): an LSTM input kernel
``W`` under a ``blstm*`` or ``fusion`` subtree, so of the trained leaves
``fusion.W`` alone, its column norm over the fan-in projected to at most
``maxnorm`` after the update.

Departures from ``multimodal.py``, each also the port's: the towers'
weights are the benchmark's seeded weights, not the pretrained speech and
skeletal files the source loads (``:68-85``); each frozen tower is run
without a backward (nothing upstream of the fusion layer trains, so no
gradient crosses the concat); and with ``precision="fp8"`` every operand
that the configuration computes in bfloat16 (the matmul operands, the
projections, the hidden streams) is rounded to float8 e4m3 instead: the
control that a lower precision must fail.

A ``blstm_ctc.Reference`` (its weights, rounding and ``log_probs``) that
reuses ``blstm_ctc.py``'s recurrence (with its hand-written adjoint and
the hard sigmoid), CTC lattice and precisions. Imports neither JAX, the JAX package
nor the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference import blstm_ctc, prng
from benchmark.reference.blstm_ctc import _Recurrence, ctc_nll, ieee_f32

TOWERS = (("speech", "enc_a"), ("skeletal", "enc_s"))
TRAINED = ("fusion", "head")


def is_constrained(name: str) -> bool:
    """The port's maxnorm rule: LSTM input kernels under blstm* or fusion."""
    parts = name.split(".")
    return parts[-1] == "W" and any(p.startswith("blstm") or p == "fusion" for p in parts[:-1])


class Reference(blstm_ctc.Reference):
    """Late fusion of ``pipeline`` (a configuration file's dict) over the
    towers of ``sources`` (``{"speech": ..., "skeletal": ...}``, pipeline
    dicts) with the weights ``weights`` (parameter name -> f32 tensor), on
    ``device``. ``log_probs`` (of the pair) and the rounding are
    ``blstm_ctc.Reference``'s."""

    def __init__(self, pipeline: Dict[str, Any], weights: Dict[str, torch.Tensor], device,
                 precision: str = "f32", *, sources: Dict[str, Dict[str, Any]]):
        super().__init__(pipeline, weights, device, precision)
        self.sources = sources

    # -- forward ------------------------------------------------------------

    def _layer(self, prefix: str, x: torch.Tensor, rate: float,
               key: Optional[prng.Key]) -> torch.Tensor:
        """One BiLSTM layer ``prefix`` over (T, B, F) -> (T, B, 2H); in train
        mode direction d's input dropout from ``fold_in(key, d)``."""
        W, U, b = (self.p[f"{prefix}.{n}"] for n in ("W", "U", "b"))
        T, B, Fin = x.shape
        H = U.shape[1]
        xps = []
        for d in (0, 1):
            xin = x
            if key is not None and rate > 0.0:
                keep = 1.0 - rate
                mask = prng.bernoulli(prng.fold_in(key, d), keep, (B, Fin), self.device)
                xin = x * (mask.float() / keep)
            xp = self._r(xin) @ self._r(W[d].reshape(Fin, 4 * H)) + b[d].reshape(4 * H)
            xps.append(self._r(xp))
        xs = torch.stack([xps[0], xps[1].flip(0)])
        hs = _Recurrence.apply(xs, U.reshape(2, H, 4 * H), self.rnd)
        return self._r(torch.cat([hs[0], hs[1].flip(0)], dim=-1))

    def _tower(self, name: str, x: torch.Tensor, noise: float,
               key: Optional[prng.Key]) -> torch.Tensor:
        """Tower ``name`` over (T, B, F): its source's depth, dropout rates
        and residual, under ``noise``; frozen, so without a backward."""
        enc = self.sources[name]["encoder"]

        def sub(n):
            return None if key is None else prng.fold_name(key, n)

        with torch.no_grad():
            h = x
            if key is not None and noise:
                h = h + noise * prng.normal(sub("noise"), tuple(h.shape), self.device)
            outs = []
            for i in range(enc["depth"]):
                rates = enc["dropout"]
                h = self._layer(f"{name}.blstm_{i}", h, rates[i] if i < len(rates) else rates[-1],
                                sub(f"drop_{i}"))
                outs.append(h)
            return outs[-2] + outs[-1] if enc["residual"] and enc["depth"] >= 2 else outs[-1]

    def logits(self, x: Tuple[torch.Tensor, torch.Tensor],
               key: Optional[prng.Key] = None) -> torch.Tensor:
        """(T, B, C) f32 logits of the pair x = ((B, T, 39), (B, T, 20));
        in train mode (a ``key``) with the noise and dropout the key's
        streams give."""
        cfg = self.cfg
        noises = (cfg["encoder"]["input_noise"], cfg["second_stream_noise"])
        res = [self._tower(name, s.to(self.device, torch.float32).transpose(0, 1), noise,
                           None if key is None else prng.fold_name(key, path))
               for (name, path), s, noise in zip(TOWERS, x, noises)]
        h = self._layer("fusion", torch.cat(res, dim=-1), cfg["fusion_dropout"],
                        None if key is None else prng.fold_name(key, "fusion_drop"))
        rate = cfg["fusion_output_dropout"]
        if key is not None and rate > 0.0:
            keep = 1.0 - rate
            mask = prng.bernoulli(prng.fold_name(key, "head_drop"), keep, tuple(h.shape),
                                  self.device)
            h = h * (mask.float() / keep)
        return self._r(h) @ self._r(self.p["head.W"]) + self.p["head.b"]

    def loss(self, batch: Dict[str, torch.Tensor], key: Optional[prng.Key]) -> torch.Tensor:
        nll = ctc_nll(self.logits((batch["inputs"], batch["inputs2"]), key),
                      batch["labels"].to(self.device), batch["input_length"],
                      batch["label_length"], self.cfg["ctc"]["trim_frames"])
        return nll.mean()

    # -- training -------------------------------------------------------------

    def train(self, batches: Sequence[Dict[str, torch.Tensor]],
              keys: Sequence[prng.Key]) -> Tuple[List[float], Dict[str, torch.Tensor]]:
        """Keras-Adam steps over ``fusion.*`` and ``head.*`` from the
        weights, one a batch. Returns each step's loss and the first step's
        gradient of those leaves as Adam takes it (after the element-wise
        clip); ``self.p`` holds every parameter after the last step, the
        towers' unchanged."""
        opt = self.cfg["optimizer"]
        b1, b2, eps, clip = opt["beta1"], opt["beta2"], opt["eps"], opt["clipvalue"]
        names = sorted(k for k in self.p if k.split(".")[0] in TRAINED)
        mu = {k: torch.zeros_like(self.p[k]) for k in names}
        nu = {k: torch.zeros_like(self.p[k]) for k in names}
        losses, first = [], None
        for t, (batch, key) in enumerate(zip(batches, keys), start=1):
            leaves = [self.p[k].requires_grad_(True) for k in names]
            with ieee_f32():
                loss = self.loss(batch, key)
                grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach().item())
            with torch.no_grad():
                step = opt["learning_rate"] / (1.0 + opt["decay"] * (t - 1))
                new = dict(self.p)
                for k, g in zip(names, grads):
                    g = torch.clamp(g, -clip, clip)
                    mu[k] = b1 * mu[k] + (1 - b1) * g
                    nu[k] = b2 * nu[k] + (1 - b2) * g * g
                    u = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                    w = self.p[k].detach() - step * u
                    if opt["maxnorm"] is not None and is_constrained(k):
                        norms = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True) + 1e-12)
                        w = w * torch.clamp(opt["maxnorm"] / norms, max=1.0)
                    new[k] = w
                    if t == 1:
                        first = first or {}
                        first[k] = g
            self.p = new
            del loss, grads, leaves
        return losses, first
