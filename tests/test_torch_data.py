"""The port's config, batch assembly and corpus readers held against the
JAX package's, which they copy so that the port needs nothing of
``mgr_tpu``: presets and their JSON equal, batches and corpora built from
the same files equal (features to 1e-6 absolute, after the z-score of
the skeletal corpus; everything else exactly)."""

import dataclasses

import numpy as np
import pytest
import torch

from mgr_tpu.core import config as jconfig
from mgr_tpu.data import batcher as jbatcher
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.data import formats as jformats
from mgr_tpu.data import vocab as jvocab
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data import batcher as tbatcher
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import formats as tformats
from mgr_tpu_torch.data import vocab as tvocab
from mgr_tpu_torch.data import synthetic

torch.set_num_threads(1)

TOL_FEATS = 1e-6


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_and_json_match_jax(name):
    jcfg, tcfg = jconfig.get_preset(name), tconfig.get_preset(name)
    assert tcfg.to_json() == jcfg.to_json()
    assert tconfig.PipelineConfig.from_json(jcfg.to_json()) == tcfg
    assert jconfig.PipelineConfig.from_json(tcfg.to_json()) == jcfg
    small = tcfg.replace(maxlen=24, encoder=tconfig.EncoderConfig(hidden=8))
    assert dataclasses.asdict(small) == dataclasses.asdict(
        jcfg.replace(maxlen=24, encoder=jconfig.EncoderConfig(hidden=8)))


def test_vocab_matches_jax():
    for table in ("GESTURE_CODES", "WORDS", "CLASS_TO_WORDS", "GESTURE_NAME_TO_ID",
                  "DECODE_IGNORE_LIST"):
        assert getattr(tvocab, table) == getattr(jvocab, table)


@pytest.mark.parametrize("n,batch_size", [(37, 4), (10, 32), (64, 8)])
def test_split_padding_and_labels_match_jax(n, batch_size):
    ids = list(range(100, 100 + n))
    assert tbatcher.reference_split(ids, 0.2, batch_size, seed=10) == \
        jbatcher.reference_split(ids, 0.2, batch_size, seed=10)
    rng = np.random.default_rng(n)
    for T in (5, 24, 40):
        x = rng.standard_normal((T, 3)).astype(np.float32)
        (tx, tn), (jx, jn) = tbatcher.pad_or_truncate(x, 24), jbatcher.pad_or_truncate(x, 24)
        np.testing.assert_array_equal(tx, jx)
        assert tn == jn
    for seq, expand in (([], False), ([2, 4, 21], True), (list(range(1, 21)), False)):
        (tl, tn), (jl, jn) = (m.prepare_labels(seq, 8, 21, expand_words=expand)
                              for m in (tbatcher, jbatcher))
        np.testing.assert_array_equal(tl, jl)
        assert tn == jn


def test_batcher_epochs_match_jax():
    rng = np.random.default_rng(0)
    n = 11
    arrays = (rng.standard_normal((n, 6, 2)).astype(np.float32),
              rng.integers(-1, 5, (n, 3)).astype(np.int32),
              rng.integers(0, 4, n).astype(np.int32),
              rng.integers(1, 6, n).astype(np.int32))
    ids = list(range(n))
    tb = tbatcher.Batcher(*arrays, ids, ids[:8], ids[8:])
    jb = jbatcher.Batcher(*arrays, ids, ids[:8], ids[8:])
    for kw in (dict(train=True), dict(train=True, shuffle_seed=3), dict(train=False)):
        tep, jep = list(tb.epoch(3, **kw)), list(jb.epoch(3, **kw))
        assert len(tep) == len(jep) == tb.num_batches(3, kw["train"])
        for (tids, tbatch), (jids, jbatch) in zip(tep, jep):
            assert tids == jids and tbatch.keys() == jbatch.keys()
            for k in tbatch:
                np.testing.assert_array_equal(tbatch[k], jbatch[k])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        root, n_files=5, frames_per_label=6, seed=2)
    sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
        root, n_files=6, frames_per_label=6, seed=1)
    return dict(audio_dir=audio_dir, audio_labels=audio_labels,
                sk_csv=sk_csv, sk_labels=sk_labels)


def test_corpus_readers_match_jax(corpora):
    for labels in (corpora["audio_labels"], corpora["sk_labels"]):
        assert tformats.load_label_csv(labels) == jformats.load_label_csv(labels)
    ids = tformats.list_audio_files(corpora["audio_dir"])
    assert ids == jformats.list_audio_files(corpora["audio_dir"]) and ids
    path = f"{corpora['audio_dir']}/audio_{ids[0]}.csv"
    t, j = tformats.load_audio_file_csv(path), jformats.load_audio_file_csv(path)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    for normalize in (False, True):
        t = tformats.load_skeletal_csv(corpora["sk_csv"], normalize=normalize)
        j = jformats.load_skeletal_csv(corpora["sk_csv"], normalize=normalize)
        assert list(t) == list(j)
        for fid in t:
            assert t[fid].dtype == j[fid].dtype == np.float32
            np.testing.assert_allclose(t[fid], j[fid], atol=TOL_FEATS, rtol=0)


@pytest.mark.parametrize("pipeline", ["speech", "skeletal"])
@pytest.mark.parametrize("mode", ["train", "val", "final"])
def test_datasets_match_jax(corpora, pipeline, mode):
    kw = dict(maxlen=40, max_label_len=12, batch_size=2)
    tcfg, jcfg = tconfig.get_preset(pipeline, **kw), jconfig.get_preset(pipeline, **kw)
    if pipeline == "speech":
        src = (corpora["audio_dir"], corpora["audio_labels"])
        t = tdatasets.build_audio_dataset(*src, tcfg, mode=mode)
        j = jdatasets.build_audio_dataset(*src, jcfg, mode=mode)
    else:
        src = (corpora["sk_csv"], corpora["sk_labels"])
        t = tdatasets.build_skeletal_dataset(*src, tcfg, mode=mode)
        j = jdatasets.build_skeletal_dataset(*src, jcfg, mode=mode)
    assert (t.file_ids, t.train_ids, t.val_ids) == (j.file_ids, j.train_ids, j.val_ids)
    np.testing.assert_allclose(t.features, j.features, atol=TOL_FEATS, rtol=0)
    for k in ("labels", "label_lengths", "input_lengths"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
