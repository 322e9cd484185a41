"""The port's ``Decoder`` with the JAX constructor,
``Decoder(predict_fn=None, pipeline="speech", spec=None, decode_fn=None)``,
and both of its modes (a port of ``tests/test_decode.py:132-168``).

On one model (skeletal, hidden 4, f32, the JAX init carried across by
``bridge.py``) the fused path (``Decoder.for_model``) equals the
posteriors path (``Decoder(predict, "skeletal", spec)``) exactly, and both
equal the JAX package's. Random weights give near-uniform posteriors, so
each frame's top-2 margin and its distance to the threshold are checked
to be ten times the two packages' largest posterior difference: no argmax
and no threshold test can flip between them. On given posteriors the
port's posteriors mode equals JAX's ``Decoder(predict_fn)`` exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mgr_tpu.core import config as jcfg
from mgr_tpu.data import vocab as jvocab
from mgr_tpu.decode import decoder as jdecoder
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train.step import make_predict_step as jpredict_step
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import config as tcfg
from mgr_tpu_torch.decode import Decoder, decode_probs
from mgr_tpu_torch.decode import decoder as tdecoder
from mgr_tpu_torch.models import build_model
from mgr_tpu_torch.train import make_predict_step

torch.set_num_threads(1)


def _cfg():
    return jcfg.get_preset("skeletal").replace(
        maxlen=20, num_feats=4, nb_classes=6, max_label_len=4, compute_dtype="float32",
        encoder=jcfg.EncoderConfig(hidden=4, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                                   output_dropout=0.0),
    )


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = bridge.load_params(
        build_model(tcfg.PipelineConfig.from_json(cfg.to_json()), device="cpu"),
        jax.tree.map(np.array, jparams))
    rng = np.random.default_rng(1)
    batch = {
        "inputs": rng.standard_normal((4, 20, 4)).astype(np.float32),
        "input_length": np.array([18, 18, 11, 6]),
        "labels": np.zeros((4, 4), np.int32),
        "label_length": np.array([1, 1, 1, 1]),
    }
    return jmodel, jparams, tmodel, batch


@pytest.mark.parametrize("threshold", [0.2, 0.0])  # JAX's test's, and one that emits
def test_fused_decoder_matches_probs_path_and_jax(models, threshold):
    jmodel, jparams, tmodel, batch = models
    jspec = jdecoder.DecodeSpec(threshold, jvocab.GESTURE_CODES, trim_frames=2)
    spec = tdecoder.DecodeSpec(**dataclasses.asdict(jspec))
    jpred = jpredict_step(jmodel)
    want_probs = np.asarray(jpred(jparams, batch["inputs"]))
    got_probs = make_predict_step(tmodel)(batch["inputs"]).numpy()
    diff = float(np.abs(got_probs - want_probs).max())
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * diff  # no argmax can flip
    assert np.abs(top2[..., 1] - spec.threshold).min() > 10 * diff  # no threshold test can
    batches = [((7, 9, 11, 13), batch)]
    for use_lengths in (False, True):
        fused = Decoder.for_model(tmodel, "skeletal", spec).decode_batches(
            iter(batches), use_lengths=use_lengths)
        probs_path = Decoder(make_predict_step(tmodel), "skeletal", spec).decode_batches(
            iter(batches), use_lengths=use_lengths)
        assert fused == probs_path
        want = jdecoder.Decoder(lambda x: jpred(jparams, x), "skeletal", jspec).decode_batches(
            iter(batches), use_lengths=use_lengths)
        assert fused == want
        assert jdecoder.Decoder.for_model(jmodel, jparams, "skeletal", jspec).decode_batches(
            iter(batches), use_lengths=use_lengths) == want
    if threshold == 0.0:
        assert any(tokens for _, tokens in fused)


def _probs(seed, B, T, C):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    cls = np.repeat(rng.integers(0, C, size=(B, T // 3)), 3, axis=1)
    np.put_along_axis(logits, cls[..., None], 4.0, axis=-1)  # confident runs
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("pipeline", ["speech", "skeletal", "early_fusion"])
def test_posteriors_mode_matches_jax(pipeline):
    C = 44 if pipeline == "speech" else 22
    probs = _probs(3, B=3, T=24, C=C)
    batch = {"inputs": probs, "input_length": np.array([22, 9, 15])}
    batches = [((4, 228, 6), batch)]
    for use_lengths in (False, True):
        want = jdecoder.Decoder(lambda x: x, pipeline).decode_batches(
            batches, use_lengths=use_lengths)
        got = Decoder(lambda x: torch.from_numpy(x), pipeline).decode_batches(
            batches, use_lengths=use_lengths)
        assert got == want
    spec = dataclasses.replace(tdecoder.DECODE_SPECS[pipeline], drop_blank=True)
    assert decode_probs(probs, spec, batch["input_length"]) == jdecoder.decode_probs(
        probs, jdecoder.DecodeSpec(**dataclasses.asdict(spec)), batch["input_length"])


def test_decoder_needs_a_step():
    with pytest.raises(ValueError, match="need predict_fn or decode_fn"):
        Decoder(pipeline="skeletal")
    with pytest.raises(ValueError):
        jdecoder.Decoder(pipeline="skeletal")
    dec = Decoder(lambda x: x, "skeletal")
    assert dec.predict_fn is not None and dec.decode_fn is None
    assert dec.spec == tdecoder.DECODE_SPECS["skeletal"]
