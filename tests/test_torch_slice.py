"""The whole serving slice of the port held against the JAX package:
speech and skeletal models with a narrow encoder and
``compute_dtype="float32"``, the port's weights bridged from the JAX
``model.init``.

Tolerances: logits 1e-4 (absolute); mean eval loss 1e-4 (relative);
decoded tokens, MLF bytes and accuracy metrics equal. Decoding is
compared in float32, where every frame's top-2 margin is checked to be
ten times the two paths' measured logits difference, so no argmax can
flip between them.
The bridge round trip is bit-exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mgr_tpu.core import checkpoint as jckpt
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng
from mgr_tpu.data.batcher import Batcher
from mgr_tpu.data.vocab import GESTURE_CODES
from mgr_tpu.decode import decoder as jdecoder
from mgr_tpu.decode import evaluate as jevaluate
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.decode import decoder as tdecoder
from mgr_tpu_torch.decode import evaluate as tevaluate
from mgr_tpu_torch.decode.mlf import entry_name, write_mlf
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.train import step as tstep

torch.set_num_threads(1)

TOL_LOGITS = 1e-4
TOL_LOSS_REL = 1e-4
T, B, N = 24, 3, 4


def _cfg(name):
    return cfglib.get_preset(name).replace(
        maxlen=T, batch_size=B, max_label_len=N, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=8, depth=2),
    )


def _port(cfg):
    """The port's own config for a JAX config, through the shared JSON."""
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _pair(name, seed=0):
    cfg = _cfg(name)
    jmodel = jbuild(cfg)
    jparams = jmodel.init(prng.root_key(seed))
    tree = jax.tree.map(np.array, jparams)
    tmodel = bridge.load_params(tbuild(_port(cfg), device="cpu"), tree)
    return cfg, jmodel, jparams, tmodel


def _batch(cfg, seed=1, n=B):
    rng = np.random.default_rng(seed)
    lab_len = rng.integers(0, N + 1, size=n).astype(np.int32)
    labels = np.full((n, N), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    return {
        "inputs": rng.standard_normal((n, T, cfg.num_feats)).astype(np.float32),
        "labels": labels,
        "input_length": rng.integers(2 * N + 1, T - 1, size=n).astype(np.int32),
        "label_length": lab_len,
    }


@pytest.mark.parametrize("name", ["speech", "skeletal"])
def test_logits_and_eval_loss_match_jax(name):
    cfg, jmodel, jparams, tmodel = _pair(name)
    batch = _batch(cfg)
    want = np.asarray(jmodel.apply(jparams, batch["inputs"]))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(batch["inputs"])).numpy()
    assert got.shape == (B, T, cfg.nb_classes)
    np.testing.assert_allclose(got, want, atol=TOL_LOGITS, rtol=0)

    jloss = float(jstep.make_eval_step(jmodel)(jparams, batch))
    tloss = float(tstep.make_eval_step(tmodel)(batch))
    assert abs(tloss - jloss) <= TOL_LOSS_REL * abs(jloss)


@pytest.mark.parametrize("name", ["speech", "skeletal"])
@pytest.mark.parametrize("threshold", [0.0, None])
def test_decoder_tokens_match_jax(name, threshold):
    cfg, jmodel, jparams, tmodel = _pair(name, seed=2)
    batch = _batch(cfg, seed=3)
    want = np.asarray(jmodel.apply(jparams, batch["inputs"]))
    with torch.inference_mode():
        diff = np.abs(tmodel(torch.from_numpy(batch["inputs"])).numpy() - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * diff  # no argmax can flip
    spec = jdecoder.DECODE_SPECS[name]
    if threshold is not None:  # random weights: the preset's threshold emits nothing
        spec = spec.__class__(**{**spec.__dict__, "threshold": threshold})
    tspec = tdecoder.DecodeSpec(**spec.__dict__)
    batches = [((1, 2, 3), batch)]
    for use_lengths in (False, True):
        want = jdecoder.Decoder.for_model(jmodel, jparams, name, spec).decode_batches(
            batches, use_lengths=use_lengths)
        got = tdecoder.Decoder.for_model(tmodel, name, tspec).decode_batches(
            batches, use_lengths=use_lengths)
        assert got == want
    if threshold == 0.0:
        assert any(tokens for _, tokens in got)


def test_evaluate_accuracy_matches_jax():
    cfg, jmodel, jparams, tmodel = _pair("skeletal", seed=4)
    batch = _batch(cfg, seed=5, n=2 * B)
    ids = list(range(10, 10 + 2 * B))
    data = Batcher(batch["inputs"], batch["labels"], batch["label_length"],
                   batch["input_length"], ids, train_ids=[], val_ids=ids)
    spec = jdecoder.DecodeSpec(0.0, jdecoder.DECODE_SPECS["skeletal"].vocab, drop_blank=True)
    want = jevaluate.evaluate_accuracy(jmodel, jparams, data, spec=spec)
    got = tevaluate.evaluate_accuracy(
        tmodel, data, spec=tdecoder.DecodeSpec(**spec.__dict__))
    assert got == want and got["N"] > 0


def test_bridge_round_trip_is_bit_exact():
    cfg, _, jparams, tmodel = _pair("speech", seed=6)
    tree = jax.tree.map(np.array, jparams)
    back = bridge.params_to_numpy(tmodel)
    flat_in, flat_out = bridge.flatten(tree), bridge.flatten(back)
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        assert flat_in[k].dtype == flat_out[k].dtype == np.float32
        np.testing.assert_array_equal(flat_out[k], flat_in[k])
    again = bridge.params_from_numpy(back)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(again[k], v)


@pytest.mark.parametrize("name", ["speech", "skeletal", "rgb", "early_fusion", "late_fusion"])
def test_full_width_state_dict_mirrors_jax_pytree(name):
    cfg = cfglib.get_preset(name)
    shapes = jax.eval_shape(jbuild(cfg).init, prng.root_key(0))
    want = {k: tuple(v.shape) for k, v in bridge.flatten(shapes).items()}
    got = {k: tuple(v.shape) for k, v in tbuild(tconfig.get_preset(name), device="cpu").state_dict().items()}
    assert got == want
    if name == "late_fusion":  # 2x500 + 2x300 -> BiLSTM(100) -> Dense(22)
        assert got["fusion.W"] == (2, 1600, 4, 100) and got["head.W"] == (200, 22)
        assert got["speech.blstm_0.U"] == (2, 500, 4, 500)
        return
    if name == "rgb":  # HWIO conv kernels; the encoder on the CNN's 4 x 4 x 48 features
        assert got["cnn.conv_0"] == (5, 5, 1, 16) and got["cnn.conv_2"] == (4, 4, 32, 48)
        assert got["encoder.blstm_0.W"] == (2, 768, 4, 512)
    H = cfg.encoder.hidden
    assert got["encoder.blstm_0.U"] == (2, H, 4, H) and got["head.W"] == (2 * H, cfg.nb_classes)


def test_checkpoint_round_trip(tmp_path):
    jcfg, _, _, tmodel = _pair("skeletal", seed=7)
    cfg = _port(jcfg)
    tckpt.save_config(str(tmp_path), "skeletal", cfg)
    tckpt.save_params(str(tmp_path), "skeletal", tmodel)
    assert tckpt.load_config(str(tmp_path), "skeletal") == cfg
    fresh = tckpt.load_params(str(tmp_path), "skeletal", tbuild(cfg, seed=99, device="cpu"))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli"))
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=6, frames_per_label=6, seed=1
    )
    return dict(sk_csv=sk_csv, sk_labels=sk_labels, labels=labels)


def test_cli_matches_jax_cli(corpus, tmp_path, capsys, monkeypatch):
    """Same weights in both packages' workdirs: decode writes the same
    MLF, evaluate reports the same metrics, infer the same tokens."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli.main import main as tmain

    cfg = _cfg("skeletal").replace(batch_size=2)
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: cfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel = jbuild(cfg)
    state = jstep.create_train_state(jmodel, prng.root_key(cfg.seed))
    jckpt.save_config(jdir, "skeletal", cfg)
    jckpt.save_checkpoint(jdir, "skeletal", state, slot="best")
    tmodel = bridge.load_params(tbuild(_port(cfg), device="cpu"), jax.tree.map(np.array, state.params))
    tckpt.save_config(tdir, "skeletal", _port(cfg))
    tckpt.save_params(tdir, "skeletal", tmodel)

    def run(main, argv):
        assert main(argv) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    data = ["--skeletal-csv", corpus["sk_csv"], "--labels", corpus["sk_labels"]]
    outs = {}
    for tag, main, wd, dev in (("jax", jmain, jdir, []),
                               ("torch", tmain, tdir, ["--device", "cpu"])):
        mlf = str(tmp_path / f"{tag}.mlf")
        dec = run(main, ["decode", "skeletal", "--workdir", wd, "--out", mlf, *dev, *data])
        ev = run(main, ["evaluate", "skeletal", "--workdir", wd, *dev, *data])
        inf = run(main, ["infer", "skeletal", corpus["sk_csv"], "--workdir", wd, *dev])
        outs[tag] = (dec["decoded"], open(mlf, "rb").read(), ev, inf)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] >= 1
    refs = str(tmp_path / "refs.mlf")
    write_mlf(refs, [(entry_name(fid), [GESTURE_CODES[c] for c in seq])
                     for fid, seq in corpus["labels"].items()])
    scores = [run(main, ["score", refs, str(tmp_path / f"{tag}.mlf"), "--partial"])
              for tag, main in (("jax", jmain), ("torch", tmain))]
    assert scores[0] == scores[1] and scores[0]["N"] > 0


def test_entry_returns_forward_and_args(monkeypatch):
    from mgr_tpu_torch import entry as entry_mod

    small = _port(_cfg("speech"))
    monkeypatch.setattr(entry_mod, "get_preset", lambda name: small)
    fn, args = entry_mod.entry(device="cpu")
    assert args[0].shape == (8, T, small.num_feats)
    out = fn(*args)
    assert out.shape == (8, T, small.nb_classes) and torch.isfinite(out).all()
