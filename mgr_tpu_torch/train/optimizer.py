"""Keras-parity optimizer (``mgr_tpu/train/optimizer.py``), on tensors.

Held to the JAX package's optax chain, not to torch's own Adam:

  * ``clip(clipvalue)``: element-wise gradient clipping before the moments;
  * ``scale_by_adam(b1, b2, eps=1e-7)`` with bias correction;
  * ``scale_by_schedule(-lr / (1 + decay * count))``, count from 0 (the
    first update uses the base rate), as Keras ``decay``;
  * with ``skip_nonfinite`` = n > 0, ``apply_if_finite``: an update whose
    gradients hold a NaN or Inf is dropped (zero update, Adam moments and
    counts unchanged) unless more than n came in a row;
  * ``freeze_mask_grads`` zeroes the gradients of frozen leaves (they stay
    in Adam, as in the JAX package);
  * ``apply_maxnorm``: Keras maxnorm(3) on the LSTM input kernels only,
    projected after the update.

Parameters and gradients are dicts keyed by ``state_dict`` names
(``encoder.blstm_0.W``). Every count lives on the parameters' device, so
an update never waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mgr_tpu_torch.core.config import OptimizerConfig

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    """optax's state of the chain: Adam's count and moments, the schedule's
    count and ``apply_if_finite``'s counters (0-d int32 tensors)."""

    count: torch.Tensor
    mu: Tensors
    nu: Tensors
    schedule_count: torch.Tensor
    notfinite_count: torch.Tensor
    total_notfinite: torch.Tensor

    def state_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def clone(self) -> "AdamState":
        def copy(x):
            return {k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()

        return AdamState(**{k: copy(v) for k, v in self.state_dict().items()})


class KerasAdam:
    """``keras_adam(cfg)``: ``init(params)`` and
    ``update(grads, state) -> (updates, state)``."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: Tensors) -> AdamState:
        dev = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamState(
            count=zero.clone(),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            schedule_count=zero.clone(),
            notfinite_count=zero.clone(),
            total_notfinite=zero.clone(),
        )

    def update(self, grads: Tensors, state: AdamState):
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        step_size = -cfg.learning_rate / (
            1.0 + cfg.decay * state.schedule_count.to(torch.float32))
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.clamp(g, -cfg.clipvalue, cfg.clipvalue)
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + cfg.eps)
            updates[k] = step_size * u
        new = AdamState(count, mu, nu, state.schedule_count + 1,
                        state.notfinite_count, state.total_notfinite)
        if not cfg.skip_nonfinite:
            return updates, new
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        notfinite = torch.where(finite, 0, state.notfinite_count + 1).to(torch.int32)
        ok = finite | (notfinite > cfg.skip_nonfinite)

        def pick(a, b):
            return torch.where(ok, a, b)

        updates = {k: pick(u, torch.zeros_like(u)) for k, u in updates.items()}
        kept = AdamState(
            count=pick(new.count, state.count),
            mu={k: pick(new.mu[k], state.mu[k]) for k in mu},
            nu={k: pick(new.nu[k], state.nu[k]) for k in nu},
            schedule_count=pick(new.schedule_count, state.schedule_count),
            notfinite_count=notfinite,
            total_notfinite=torch.where(
                finite, state.total_notfinite, state.total_notfinite + 1
            ).to(torch.int32),
        )
        return updates, kept


def keras_adam(cfg: OptimizerConfig) -> KerasAdam:
    return KerasAdam(cfg)


def freeze_mask_grads(grads: Tensors, trainable: Dict[str, bool]) -> Tensors:
    """Zero gradients of frozen leaves (trainable=False)."""
    return {k: g if trainable[k] else torch.zeros_like(g) for k, g in grads.items()}


def is_constrained_kernel(name: str) -> bool:
    """LSTM input kernels ``W`` under a blstm / fusion subtree carry
    maxnorm(3); recurrent kernels ``U``, biases, dense and conv do not."""
    parts = name.split(".")
    return parts[-1] == "W" and any(
        p.startswith("blstm") or p == "fusion" for p in parts[:-1])


def apply_maxnorm(params: Tensors, max_value: Optional[float]) -> Tensors:
    """Project constrained kernels to column norm <= max_value. Kernel
    W (D, F, 4, H): a Keras kernel column is the fan-in slice of one
    (direction, gate, unit), so the norm reduces over axis 1, with 1e-12
    inside the square root."""
    if max_value is None:
        return params
    out = {}
    for k, w in params.items():
        if is_constrained_kernel(k):
            norms = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True) + 1e-12)
            w = w * torch.clamp(max_value / norms, max=1.0)
        out[k] = w
    return out


def global_norm(tensors: Tensors) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of squares."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tensors.values()))


def plateau_from_config(cfg) -> "ReduceLROnPlateau | None":
    """The plateau controller a PipelineConfig describes (or None)."""
    if cfg.reduce_lr_factor is None:
        return None
    return ReduceLROnPlateau(
        cfg.reduce_lr_factor, cfg.reduce_lr_patience,
        cfg.reduce_lr_min, cfg.optimizer.learning_rate,
        min_delta=cfg.reduce_lr_min_delta,
        cooldown=cfg.reduce_lr_cooldown,
    )


class ReduceLROnPlateau:
    """Host-side LR controller matching keras.callbacks.ReduceLROnPlateau
    (factor / patience / min_lr / min_delta / cooldown), tracked as a
    multiplicative scale the train step consumes
    (``mgr_tpu/train/optimizer.py:109-176``)."""

    def __init__(self, factor: float, patience: int, min_lr: float,
                 base_lr: float, min_delta: float = 1e-4,
                 cooldown: int = 0):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / base_lr
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = float("inf")
        self.wait = 0
        self.scale = 1.0

    def is_pristine(self) -> bool:
        """True while the controller has seen no loss: fit(resume=True)
        restores the state in the fitmeta only into such a controller, so
        a caller's annealed controller (its state newer than the disk's)
        is never overwritten."""
        return (self.scale == 1.0 and self.best == float("inf")
                and self.wait == 0 and self.cooldown_counter == 0)

    def state_dict(self) -> dict:
        """JSON-serializable mutable state (kept in the fitmeta sidecar, so
        a resumed run continues at the annealed rate)."""
        return {"scale": self.scale, "best": self.best,
                "wait": self.wait,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d: dict) -> None:
        self.scale = float(d["scale"])
        self.best = float(d["best"])
        self.wait = int(d["wait"])
        self.cooldown_counter = int(d["cooldown_counter"])

    def update(self, monitored: float) -> float:
        # Keras cooldown: for `cooldown` updates after a reduction,
        # patience does not accumulate.
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        # Improvements below min_delta do not reset patience.
        if monitored < self.best - self.min_delta:
            self.best = monitored
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return self.scale
