"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests, and ``calibrate.py`` for the readings a limit is set
from). Each patches the port for the length of a ``with`` block:

  frozen_state   a train step returns its state unchanged
  half_batch     a train step computes on the first half of its rows (the
                 mean over them); a decode step decodes the first half and
                 hands those rows back for the rest too
  token_device   one frame's class altered at the decode step's output
  token_host     a token added to the first row's tokens on the host
  never_emits    the decode step's emit mask all false
  wrong_table    the decoder maps ids to words through a table shifted by one
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

FAULTS: Dict[str, Tuple[str, ...]] = {
    "train": ("frozen_state", "half_batch"),
    "decode": ("half_batch", "token_device", "token_host", "never_emits", "wrong_table"),
    "infer": ("token_device", "token_host", "never_emits", "wrong_table"),
}


@contextlib.contextmanager
def planted(name: str):
    import torch

    from mgr_tpu_torch.decode import decoder as dec_mod
    from mgr_tpu_torch.train import step as step_mod

    saved = []

    def patch(module, attr, new):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, new)

    if name == "frozen_state":
        patch(step_mod, "_apply_updates",
              lambda model, state, tx, loss, grads, lr_scale: (state, {"loss": loss,
                                                                        "grad_norm": loss * 0}))
    elif name == "half_batch":
        loss_and_grads, make_decode_step = step_mod._loss_and_grads, dec_mod.make_decode_step

        def half_loss(model, params, batch, rng, local=lambda mb: mb):
            n = batch["inputs"].shape[0] // 2
            return loss_and_grads(model, params, {k: v[:n] for k, v in batch.items()}, rng, local)

        def half_decode(model, **kw):
            step = make_decode_step(model, **kw)

            def halved(inputs, lengths=None):
                n = inputs.shape[0]
                h = max(1, n // 2)
                best, emit = step(inputs[:h], None if lengths is None else lengths[:h])
                reps = -(-n // h)
                return best.repeat(reps, 1)[:n], emit.repeat(reps, 1)[:n]

            return halved

        patch(step_mod, "_loss_and_grads", half_loss)
        patch(dec_mod, "make_decode_step", half_decode)
    elif name == "token_device":
        make_decode_step = dec_mod.make_decode_step

        def altered_decode(model, **kw):
            step = make_decode_step(model, **kw)
            classes = model.config.nb_classes

            def altered(inputs, lengths=None):
                best, emit = step(inputs, lengths)
                best = best.clone()
                best[:, 5] = (best[:, 5] + 1) % classes
                return best, emit

            return altered

        patch(dec_mod, "make_decode_step", altered_decode)
    elif name == "token_host":
        emitted = dec_mod.emitted_sequences

        def altered_tokens(best, emit):
            seqs = emitted(best, emit)
            seqs[0] = seqs[0] + [1]
            return seqs

        patch(dec_mod, "emitted_sequences", altered_tokens)
    elif name == "never_emits":
        make_decode_step = dec_mod.make_decode_step

        def silent_decode(model, **kw):
            step = make_decode_step(model, **kw)

            def silent(inputs, lengths=None):
                best, emit = step(inputs, lengths)
                return best, torch.zeros_like(emit)

            return silent

        patch(dec_mod, "make_decode_step", silent_decode)
    elif name == "wrong_table":
        specs = dict(dec_mod.DECODE_SPECS)
        for pipeline, spec in specs.items():
            ids = sorted(spec.vocab)
            shifted = {i: spec.vocab[ids[(j + 1) % len(ids)]] for j, i in enumerate(ids)}
            specs[pipeline] = dataclasses.replace(spec, vocab=shifted)
        patch(dec_mod, "DECODE_SPECS", specs)
    else:
        raise KeyError(f"no fault {name!r}")
    try:
        yield
    finally:
        for module, attr, old in reversed(saved):
            setattr(module, attr, old)
