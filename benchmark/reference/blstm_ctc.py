"""Plain PyTorch reference of the reference repository's BLSTM+CTC
recognisers (speech: ``audio_network/speech_lstm_ctc_words.py:32-134``;
rgb: ``rgb_network/cnn_lstm.py:251-375``), in float32 with TF32 off.

The model, from the configuration file's ``pipeline``: (rgb) three
TimeDistributed VALID conv + bias + relu + 2x2 max-pool blocks over every
frame, flattened (h, w, c); GaussianNoise; ``depth`` BiLSTM layers
(Keras-2 LSTM: gates i, f, g, o, ``hard_sigmoid`` = clamp(0.2 x + 0.5, 0,
1) on i, f, o, tanh on g and on the cell) with input dropout, one mask a
direction constant over time; the residual sum of the last two layers;
dropout; Dense to the classes; CTC (blank = classes - 1) after the first
``trim_frames`` frames; Keras Adam (element-wise clip, bias correction,
inverse-time decay) and maxnorm on the BiLSTM input kernels.

The recurrence is written out as a loop over time with its adjoint (BPTT)
by hand, so that the saved state is one (T, B, 4H) tensor a direction
rather than autograd's graph of every step. Noise and dropout come from
``benchmark.reference.prng``, the same keys giving the same masks as the
port's. With ``precision="fp8"`` every operand that the configuration
computes in bfloat16 (matmul and convolution operands, the projections,
the hidden streams, the conv outputs) is rounded to float8 e4m3 instead:
the control that a lower precision must fail.

Imports neither JAX, the JAX package nor the port.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference import prng

NEG = -1e30
CNN_CHUNK = 4096  # frames a checkpointed CNN block recomputes at once


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(torch.float32)


PRECISIONS: Dict[str, Optional[Callable]] = {"f32": None, "fp8": _fp8}


@contextlib.contextmanager
def ieee_f32():
    """float32 matmuls and convolutions without TF32; the flags restored."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def hard_sigmoid(z: torch.Tensor) -> torch.Tensor:
    return torch.clamp(0.2 * z + 0.5, 0.0, 1.0)


class _Recurrence(torch.autograd.Function):
    """Both directions of one BiLSTM layer over pre-activations already in
    scan order: xs (2, T, B, 4H), U (2, H, 4H) -> hs (2, T, B, H), zero
    initial state, f32 carries."""

    @staticmethod
    def forward(ctx, xs, U, rnd):
        D, T, B, G = xs.shape
        H = G // 4
        Ur = U if rnd is None else rnd(U)
        h = xs.new_zeros((D, B, H))
        c = xs.new_zeros((D, B, H))
        zs = torch.empty_like(xs)
        hs = xs.new_empty((D, T, B, H))
        cs = torch.empty_like(hs)
        for s in range(T):
            z = torch.baddbmm(xs[:, s], h if rnd is None else rnd(h), Ur)
            sg = hard_sigmoid(z)
            c = sg[..., H:2 * H] * c + sg[..., :H] * torch.tanh(z[..., 2 * H:3 * H])
            h = sg[..., 3 * H:] * torch.tanh(c)
            zs[:, s], cs[:, s], hs[:, s] = z, c, h
        ctx.save_for_backward(zs, cs, hs, Ur)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        zs, cs, hs, U = ctx.saved_tensors
        D, T, B, G = zs.shape
        H = G // 4
        UT = U.transpose(1, 2)
        dh = zs.new_zeros((D, B, H))
        dc = zs.new_zeros((D, B, H))
        dxs = torch.empty_like(zs)
        for s in reversed(range(T)):
            z = zs[:, s]
            sg = hard_sigmoid(z)
            slope = ((z > -2.5) & (z < 2.5)).to(z.dtype) * 0.2
            i, f, o = sg[..., :H], sg[..., H:2 * H], sg[..., 3 * H:]
            g = torch.tanh(z[..., 2 * H:3 * H])
            tc = torch.tanh(cs[:, s])
            c_prev = cs[:, s - 1] if s > 0 else torch.zeros_like(tc)
            dh = dh + dhs[:, s]
            dc = dc + dh * o * (1.0 - tc * tc)
            dz = torch.cat([dc * g * slope[..., :H], dc * c_prev * slope[..., H:2 * H],
                            dc * i * (1.0 - g * g), dh * tc * slope[..., 3 * H:]], dim=-1)
            dxs[:, s] = dz
            dc = dc * f
            dh = torch.bmm(dz, UT)
        h_prev = torch.cat([hs.new_zeros((D, 1, B, H)), hs[:, :-1]], dim=1)
        dU = torch.bmm(h_prev.reshape(D, T * B, H).transpose(1, 2), dxs.reshape(D, T * B, G))
        return dxs, dU, None


def ctc_nll(logits_tm: torch.Tensor, labels: torch.Tensor, input_length: torch.Tensor,
            label_length: torch.Tensor, trim: int) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood (B,) over the extended
    label lattice (blank, l1, blank, ..., lL, blank), blank = C - 1, after
    dropping the first ``trim`` frames; ``input_length`` counts the frames
    after the trim."""
    lp = torch.log_softmax(logits_tm[trim:].float(), dim=-1)
    T, B, C = lp.shape
    blank = C - 1
    L = max(1, int(label_length.max()))
    S = 2 * L + 1
    lab = labels[:, :L].long().clamp_min(0)
    ext = torch.full((B, S), blank, dtype=torch.long, device=lp.device)
    ext[:, 1::2] = lab
    lpe = torch.gather(lp, 2, ext[None].expand(T, B, S))
    skip = torch.zeros((B, S), dtype=torch.bool, device=lp.device)
    skip[:, 3::2] = ext[:, 3::2] != ext[:, 1:-2:2]
    neg1 = lp.new_full((B, 1), NEG)
    neg2 = lp.new_full((B, 2), NEG)
    alpha = torch.cat([lpe[0, :, :2], lp.new_full((B, S - 2), NEG)], dim=1)
    in_len = input_length.to(lp.device).long()
    for t in range(1, T):
        a1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg2, alpha[:, :-2]], dim=1), NEG)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + lpe[t]
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    n = label_length.to(lp.device).long()
    rows = torch.arange(B, device=lp.device)
    last = alpha[rows, 2 * n]
    before = torch.where(n > 0, alpha[rows, (2 * n - 1).clamp_min(0)], NEG)
    return -torch.logaddexp(last, before)


def is_constrained(name: str) -> bool:
    """The BiLSTM input kernels, which carry Keras maxnorm."""
    parts = name.split(".")
    return parts[-1] == "W" and any(p.startswith("blstm") for p in parts[:-1])


class Reference:
    """The pipeline of ``pipeline`` (a configuration file's dict) with the
    weights ``weights`` (parameter name -> f32 tensor), on ``device``."""

    def __init__(self, pipeline: Dict[str, Any], weights: Dict[str, torch.Tensor], device,
                 precision: str = "f32"):
        self.cfg = pipeline
        self.device = torch.device(device)
        self.rnd = PRECISIONS[precision]
        self.p = {k: w.detach().to(self.device, torch.float32).clone() for k, w in weights.items()}

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        """Rounded to the precision under test, the gradient passed straight."""
        if self.rnd is None:
            return x
        return x + (self.rnd(x) - x).detach()

    # -- forward ------------------------------------------------------------

    def _cnn_block(self, frames: torch.Tensor, params: List[torch.Tensor]) -> torch.Tensor:
        cnn = self.cfg["cnn"]
        y = frames
        for i, p in enumerate(cnn["pool_sizes"]):
            w, b = params[2 * i], params[2 * i + 1]
            y = F.conv2d(self._r(y), self._r(w).permute(3, 2, 0, 1))
            y = F.max_pool2d(F.relu(self._r(y + b[:, None, None])), p)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) inputs, or rgb's (B, T, D, D, 1) video -> (B, T, F')."""
        if not self.cfg.get("cnn"):
            return x
        B, T, D, _, Cin = x.shape
        frames = x.reshape(B * T, D, D, Cin).permute(0, 3, 1, 2)
        params = []
        for i in range(len(self.cfg["cnn"]["pool_sizes"])):
            params += [self.p[f"cnn.conv_{i}"], self.p[f"cnn.bias_{i}"]]
        out = []
        for a in range(0, B * T, CNN_CHUNK):
            chunk = frames[a:a + CNN_CHUNK]
            if torch.is_grad_enabled():
                out.append(torch.utils.checkpoint.checkpoint(
                    self._cnn_block, chunk, params, use_reentrant=False))
            else:
                out.append(self._cnn_block(chunk, params))
        return torch.cat(out).reshape(B, T, -1)

    def _bilstm(self, i: int, x: torch.Tensor, rate: float, key: Optional[prng.Key]):
        W, U, b = (self.p[f"encoder.blstm_{i}.{n}"] for n in ("W", "U", "b"))
        T, B, Fin = x.shape
        H = U.shape[1]
        xps = []
        for d in (0, 1):
            xin = x
            if key is not None and rate > 0.0:
                keep = 1.0 - rate
                mask = prng.bernoulli(prng.fold_in(prng.fold_name(key, f"drop_{i}"), d),
                                      keep, (B, Fin), self.device)
                xin = x * (mask.float() / keep)
            xp = self._r(xin) @ self._r(W[d].reshape(Fin, 4 * H)) + b[d].reshape(4 * H)
            xps.append(self._r(xp))
        xs = torch.stack([xps[0], xps[1].flip(0)])
        hs = _Recurrence.apply(xs, U.reshape(2, H, 4 * H), self.rnd)
        return self._r(torch.cat([hs[0], hs[1].flip(0)], dim=-1))

    def logits(self, x: torch.Tensor, key: Optional[prng.Key] = None) -> torch.Tensor:
        """(T, B, C) f32 logits; in train mode (a ``key``) with the noise
        and dropout the key's streams give."""
        enc = self.cfg["encoder"]
        h = self.features(x.to(self.device, torch.float32)).transpose(0, 1)
        T, B, Fin = h.shape
        if key is not None and enc["input_noise"]:
            h = h + enc["input_noise"] * prng.normal(prng.fold_name(key, "noise"), (T, B, Fin),
                                                     self.device)
        outs = []
        for i in range(enc["depth"]):
            rates = enc["dropout"]
            h = self._bilstm(i, h, rates[i] if i < len(rates) else rates[-1], key)
            outs.append(h)
        h = outs[-2] + outs[-1] if enc["residual"] and enc["depth"] >= 2 else outs[-1]
        rate = enc["output_dropout"]
        if key is not None and rate > 0.0:
            keep = 1.0 - rate
            mask = prng.bernoulli(prng.fold_name(key, "head_drop"), keep, tuple(h.shape),
                                  self.device)
            h = h * (mask.float() / keep)
        return self._r(h) @ self._r(self.p["head.W"]) + self.p["head.b"]

    def log_probs(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T - trim, C) log-posteriors of the decode (no noise, no dropout)."""
        trim = self.cfg["ctc"]["trim_frames"]
        with torch.no_grad(), ieee_f32():
            return torch.log_softmax(self.logits(x)[trim:].float(), dim=-1).transpose(0, 1)

    def loss(self, batch: Dict[str, torch.Tensor], key: Optional[prng.Key]) -> torch.Tensor:
        nll = ctc_nll(self.logits(batch["inputs"], key), batch["labels"].to(self.device),
                      batch["input_length"], batch["label_length"],
                      self.cfg["ctc"]["trim_frames"])
        return nll.mean()

    # -- training -------------------------------------------------------------

    def train(self, batches: Sequence[Dict[str, torch.Tensor]],
              keys: Sequence[prng.Key]) -> Tuple[List[float], Dict[str, torch.Tensor]]:
        """Keras-Adam steps from the weights, one a batch. Returns each
        step's loss and the first step's gradient as Adam takes it (after
        the element-wise clip); ``self.p`` holds the parameters after the
        last step."""
        opt = self.cfg["optimizer"]
        b1, b2, eps, clip = opt["beta1"], opt["beta2"], opt["eps"], opt["clipvalue"]
        mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        losses, first = [], None
        names = sorted(self.p)
        for t, (batch, key) in enumerate(zip(batches, keys), start=1):
            leaves = [self.p[k].requires_grad_(True) for k in names]
            with ieee_f32():
                loss = self.loss(batch, key)
                grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach().item())
            with torch.no_grad():
                step = opt["learning_rate"] / (1.0 + opt["decay"] * (t - 1))
                new = {}
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
