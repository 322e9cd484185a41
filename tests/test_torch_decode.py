"""The port's decode path (best-path, MLF writer, scorer, decode_probs)
held against the JAX package on the same probabilities.

``best_path_decode`` must give exactly the JAX ``(best, emit)``; the MLF
writer the same bytes; the scorer the same metrics.
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgr_tpu.decode import decoder as jdecoder
from mgr_tpu.decode import mlf as jmlf
from mgr_tpu.decode import scorer as jscorer
from mgr_tpu.ops import decoding as jdec
from mgr_tpu_torch.decode import decoder as tdecoder
from mgr_tpu_torch.decode import mlf as tmlf
from mgr_tpu_torch.decode import scorer as tscorer
from mgr_tpu_torch.ops import decoding as tdec

torch.set_num_threads(1)


def _probs(seed, B=3, T=24, C=6, peaky=True):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    if peaky:  # runs of one confident class, so repeats and thresholds bite
        cls = np.repeat(rng.integers(0, C, size=(B, T // 3)), 3, axis=1)
        np.put_along_axis(logits, cls[..., None], 4.0, axis=-1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 0.6])
@pytest.mark.parametrize("trim", [0, 2])
@pytest.mark.parametrize("blank", [None, 5])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("collapse", [True, False])
def test_best_path_matches_jax_exactly(threshold, trim, blank, lengths, collapse):
    probs = _probs(1)
    in_len = np.array([20, 7, 22 - trim], np.int32) if lengths else None
    kw = dict(threshold=threshold, trim_frames=trim, collapse=collapse, blank=blank)
    jb, je = jdec.best_path_decode(
        jnp.asarray(probs), None if in_len is None else jnp.asarray(in_len), **kw
    )
    tb, te = tdec.best_path_decode(
        torch.from_numpy(probs), None if in_len is None else torch.from_numpy(in_len), **kw
    )
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tdec.emitted_sequences(tb, te) == jdec.emitted_sequences(jb, je)


@pytest.mark.parametrize("pipeline", ["speech", "skeletal"])
def test_decode_probs_matches_jax(pipeline):
    C = 44 if pipeline == "speech" else 22
    probs = _probs(2, B=4, T=30, C=C)
    spec = tdecoder.DECODE_SPECS[pipeline]
    assert asdict(spec) == asdict(jdecoder.DECODE_SPECS[pipeline])
    assert tdecoder.MLF_FILENAMES == jdecoder.MLF_FILENAMES
    lengths = np.array([30, 12, 25, 2], np.int32)
    assert tdecoder.decode_probs(probs, spec, lengths) == \
        jdecoder.decode_probs(probs, jdecoder.DECODE_SPECS[pipeline], lengths)


def test_decoder_predict_path_and_mlf_bytes_match_jax(tmp_path):
    """The port's Decoder on a decode step over given probabilities
    against the JAX Decoder's predict path over the same ones."""
    probs = _probs(3, B=3, T=24, C=44)
    batches = [((228, 5, 7), {"inputs": probs, "input_length": np.full(3, 22)})]
    spec = tdecoder.DECODE_SPECS["speech"]

    def decode_fn(p, lengths):
        return tdec.best_path_decode(torch.from_numpy(p), lengths, threshold=spec.threshold,
                                     trim_frames=spec.trim_frames)

    tdec_ = tdecoder.Decoder(pipeline="speech", decode_fn=decode_fn)
    jdec_ = jdecoder.Decoder(lambda x: x, "speech")
    tres = tdec_.decode_batches(batches)
    assert tres == jdec_.decode_batches(batches)
    tdec_.write_mlf(tmp_path / "t.mlf", tres)
    jdec_.write_mlf(tmp_path / "j.mlf", tres)
    assert (tmp_path / "t.mlf").read_bytes() == (tmp_path / "j.mlf").read_bytes()
    # File 228 is on the reference's ignore list.
    assert set(tmlf.read_mlf(tmp_path / "t.mlf")) == {"Sample00005_audio", "Sample00007_audio"}
    assert tmlf.read_mlf(tmp_path / "t.mlf") == jmlf.read_mlf(tmp_path / "j.mlf")


def test_scorer_matches_jax():
    rng = np.random.default_rng(4)
    refs = {str(i): rng.integers(0, 5, size=rng.integers(0, 8)).tolist() for i in range(20)}
    hyps = {k: (v[1:] + rng.integers(0, 5, size=2).tolist()) for k, v in refs.items()}
    for r, h in zip(refs.values(), hyps.values()):
        assert tscorer.edit_distance(r, h) == jscorer.edit_distance(r, h)
    assert tscorer.score_sequences(refs, hyps) == jscorer.score_sequences(refs, hyps)


def test_beam_search_copy_matches_jax():
    from mgr_tpu.decode.beam import beam_decode_batch as jbeam
    from mgr_tpu_torch.decode.beam import beam_decode_batch as tbeam

    probs = _probs(5, B=3, T=18, C=6)
    lengths = np.array([16, 9, 16], np.int32)
    for kw in (dict(beam_width=4, trim_frames=2), dict(beam_width=2, trim_frames=0)):
        assert tbeam(probs, lengths, **kw) == jbeam(probs, lengths, **kw)
