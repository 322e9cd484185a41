"""Residual BLSTM encoder: GaussianNoise -> BiLSTM x depth -> residual
sum of the last two layers (``mgr_tpu/models/encoder.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mgr_tpu_torch.core import prng
from mgr_tpu_torch.core.config import EncoderConfig
from mgr_tpu_torch.models.layers import gaussian_noise
from mgr_tpu_torch.ops import dispatch, lstm


class BiLSTM(nn.Module):
    """One bidirectional layer: trainable gate-blocked ``W (2, F, 4, H)``,
    ``U (2, H, 4, H)``, ``b (2, 4, H)`` (``ops/lstm.py:54-81``)."""

    def __init__(self, params: lstm.Params):
        super().__init__()
        self.W = nn.Parameter(params["W"])
        self.U = nn.Parameter(params["U"])
        self.b = nn.Parameter(params["b"])

    def forward(self, x_tm: torch.Tensor, *, rng: Optional[prng.Key] = None,
                dropout: float = 0.0, per_gate: bool = False,
                train: bool = False, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return lstm.bilstm_layer_tm(
            {"W": self.W, "U": self.U, "b": self.b}, x_tm, rng=rng,
            dropout=dropout, per_gate=per_gate, train=train,
            compute_dtype=compute_dtype,
        )


class Encoder(nn.Module):
    """Submodules ``blstm_0 .. blstm_{depth-1}``, as in the JAX pytree
    (``encoder.blstm_0.W`` <-> ``params["encoder"]["blstm_0"]["W"]``)."""

    def __init__(self, in_dim: int, cfg: EncoderConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = in_dim
        for i in range(cfg.depth):
            self.add_module(
                f"blstm_{i}",
                BiLSTM(lstm.init_bilstm_params(generator, d, cfg.hidden)),
            )
            d = 2 * cfg.hidden

    def apply_tm(self, x_tm: torch.Tensor, *, train: bool = False,
                 rng: Optional[prng.Key] = None, compute_dtype=torch.bfloat16,
                 noise_override: Optional[float] = None) -> torch.Tensor:
        """(T, B, F) -> (T, B, 2H) residual stream in the compute dtype
        (``apply_encoder_tm``, ``mgr_tpu/models/encoder.py:36-72``): noise
        of ``noise_override`` if given, else the config's, from
        ``fold_name(rng, "noise")``; layer i's dropout from
        ``fold_name(rng, f"drop_{i}")``. On the GSPMD route ``x_tm`` is
        this rank's time slice and every layer takes its slice of the
        whole stream the layer before gives (``dispatch.local_time``)."""
        cfg = self.cfg

        def sub(name):
            return None if rng is None else prng.fold_name(rng, name)

        sigma = cfg.input_noise if noise_override is None else noise_override
        h = gaussian_noise(x_tm, sigma, sub("noise"), train, batch_axis=1, time_axis=0)
        outs = []
        for i in range(cfg.depth):
            rate = cfg.dropout[i] if i < len(cfg.dropout) else cfg.dropout[-1]
            h = getattr(self, f"blstm_{i}")(
                h if i == 0 else dispatch.local_time(h), rng=sub(f"drop_{i}"), dropout=rate,
                per_gate=cfg.per_gate_dropout, train=train,
                compute_dtype=compute_dtype,
            )
            outs.append(h)
        if self.cfg.residual and self.cfg.depth >= 2:
            return outs[-2] + outs[-1]
        return outs[-1]

    def apply(self, x: torch.Tensor, *, train: bool = False,
              rng: Optional[prng.Key] = None, compute_dtype=torch.bfloat16,
              noise_override: Optional[float] = None) -> torch.Tensor:
        """Batch-major (B, T, F) -> (B, T, 2H) (``apply_encoder``,
        ``mgr_tpu/models/encoder.py:75-101``): :meth:`apply_tm` between two
        transposes. ``noise_override`` re-applies an encoder under another
        input noise (late fusion)."""
        out_tm = self.apply_tm(x.transpose(0, 1), train=train, rng=rng,
                               compute_dtype=compute_dtype, noise_override=noise_override)
        return out_tm.transpose(0, 1)
