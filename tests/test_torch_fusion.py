"""The two fusion families of the port (early fusion, and late fusion over
frozen encoders) held against the JAX package's: the labelled audio CSV
reader and both corpus builders, both models' logits, one train step of
each, the frozen encoders' step, the bridge of a JAX late-fusion tree and
`train`/`decode`/`evaluate early_fusion` through both CLIs.

The JAX draws are substituted on the same fold paths
(``torch_jax_draws.jax_streams``); bf16 runs JAX with
``mgr_tpu.ops.dispatch.MODE = "pallas"`` (the Pallas kernels in interpret
mode), f32 its XLA path.

Tolerances, each with its reason:
  * corpus features 1e-6 absolute (z-scores of the same f32 columns summed
    in another order); everything else in a corpus exactly.
  * f32 logits 1e-4 absolute (f32 sums in another order); bf16 logits
    3e-2 absolute (bf16 h streams, one bf16 ulp of h is ~4e-3), as the
    uni-modal slice and the recurrence tests hold them.
  * train step: loss 1e-4 relative (f32) / 1e-3 (bf16), gradients 1e-4 /
    1e-2 relative Frobenius per parameter, grad norm alike; the updated
    parameters as ``test_torch_train._params_close`` (Adam's first update
    flips where a tiny gradient's sign differs).
  * CLI: best losses 1e-4 relative; config, MLF and metrics equal.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgr_tpu.core import checkpoint as jckpt
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.data import batcher as jbatcher
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.data import formats as jformats
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.ops import dispatch as jdispatch
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.data import batcher as tbatcher
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import formats as tformats
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.train import step as tstep
from test_torch_train import _params_close
from torch_jax_draws import jax_key, jax_streams  # noqa: F401

torch.set_num_threads(1)

T, B, N = 24, 3, 4
TOL_FEATS = 1e-6
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_LOSS = {"float32": 1e-4, "bfloat16": 1e-3}
TOL_GRAD = {"float32": 1e-4, "bfloat16": 1e-2}


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _small(name, **kw):
    return cfglib.get_preset(name).replace(maxlen=T, batch_size=B, max_label_len=N, **kw)


def early_cfg(dtype="float32", **kw):
    """The early-fusion preset at test size: noise 0.5 on both streams,
    input dropout 0.4/0.4, head dropout 0.4, 22 classes."""
    return _small("early_fusion", compute_dtype=dtype,
                  encoder=cfglib.EncoderConfig(hidden=8, depth=2, dropout=(0.4, 0.4),
                                               output_dropout=0.4), **kw)


def late_cfgs(dtype="float32", sources_kw=None, **kw):
    """The late-fusion preset at test size (fusion_hidden 4, dropout 0.5
    and 0.5, speech noise 0.5, skeletal 0.0) over speech (H=8, dropout
    0.4/0.5) and skeletal (H=6, 0.6/0.6) source configs."""
    skw = sources_kw or {}
    sources = {
        "speech": _small("speech", encoder=cfglib.EncoderConfig(
            hidden=8, depth=2, **skw.get("speech", {}))),
        "skeletal": _small("skeletal", encoder=cfglib.EncoderConfig(
            hidden=6, depth=2, dropout=(0.6, 0.6), output_dropout=0.6,
            **skw.get("skeletal", {}))),
    }
    return _small("late_fusion", compute_dtype=dtype, fusion_hidden=4, **kw), sources


def pair(cfg, sources=None, seed=0):
    """The JAX model and the port's on the same weights: the port's seeded
    init, carried to JAX by the bridge (the JAX init costs an XLA compile
    and is not under test here)."""
    tsources = None if sources is None else {k: _port(v) for k, v in sources.items()}
    tmodel = tbuild(_port(cfg), tsources, seed=seed, device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tmodel))
    return jbuild(cfg, sources), jparams, tmodel


def two_stream_batch(cfg, seed=1, n=B):
    rng = np.random.default_rng(seed)
    lab_len = rng.integers(1, N + 1, size=n).astype(np.int32)
    lab_len[0] = 0
    labels = np.full((n, N), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    return {
        "inputs": rng.standard_normal((n, T, cfg.num_feats)).astype(np.float32),
        "inputs2": rng.standard_normal((n, T, cfg.second_stream_feats)).astype(np.float32),
        "labels": labels,
        "input_length": rng.integers(2 * N + 1, T - 1, size=n).astype(np.int32),
        "label_length": lab_len,
    }


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(tree).items()}


def _family(name, dtype="float32"):
    if name == "early_fusion":
        return early_cfg(dtype), None
    return late_cfgs(dtype)


# -------------------------------------------------------------- the corpora


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A fusion corpus: skeletal CSV and labels, per-file audio CSVs of the
    same files at 5x the frame rate, and the labelled monolithic audio CSV
    (with a file the skeletal CSV lacks)."""
    root = str(tmp_path_factory.mktemp("torch_fusion"))
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=10, frames_per_label=6, seed=3)
    audio_dir, _, _ = synthetic.make_audio_dataset(
        root, labels=labels, frames_per_label=30, seed=4)
    mono = synthetic.make_monolithic_audio_dataset(
        root, {**labels, 99: [5, 5, 7]}, frames_per_label=30, seed=5)
    return dict(sk_csv=sk_csv, labels=sk_labels, audio_dir=audio_dir, audio_csv=mono)


def test_monolithic_audio_csv_matches_jax(corpus):
    for normalize in (False, True):
        t = tformats.load_monolithic_audio_csv(corpus["audio_csv"], normalize=normalize)
        j = jformats.load_monolithic_audio_csv(corpus["audio_csv"], normalize=normalize)
        assert list(t) == list(j) and 99 in t
        for fid in t:
            (tf, tl), (jf, jl) = t[fid], j[fid]
            assert tf.dtype == jf.dtype == np.float32 and tl.dtype == jl.dtype == np.int32
            np.testing.assert_allclose(tf, jf, atol=TOL_FEATS, rtol=0)
            np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("family", ["early_fusion", "late_fusion"])
@pytest.mark.parametrize("mode", ["train", "val", "final"])
def test_fusion_datasets_match_jax(corpus, family, mode):
    """Array for array, and one epoch of two-stream batches."""
    kw = dict(maxlen=40, max_label_len=12, batch_size=2)
    tcfg, jcfg = tconfig.get_preset(family, **kw), cfglib.get_preset(family, **kw)
    if family == "early_fusion":
        src = (corpus["audio_csv"], corpus["sk_csv"])
        t = tdatasets.build_early_fusion_dataset(*src, tcfg, mode=mode)
        j = jdatasets.build_early_fusion_dataset(*src, jcfg, mode=mode)
    else:
        src = (corpus["audio_dir"], corpus["sk_csv"], corpus["labels"])
        t = tdatasets.build_late_fusion_dataset(*src, tcfg, mode=mode)
        j = jdatasets.build_late_fusion_dataset(*src, jcfg, mode=mode)
    assert (t.file_ids, t.train_ids, t.val_ids) == (j.file_ids, j.train_ids, j.val_ids)
    assert 99 not in t.file_ids and len(t.file_ids) == 10
    assert isinstance(t.features, tuple) and len(t.features) == 2
    for a, b in zip(t.features, j.features):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL_FEATS, rtol=0)
    for k in ("labels", "label_lengths", "input_lengths"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    train = mode == "train"
    tep, jep = list(t.epoch(2, train=train, shuffle_seed=1)), list(j.epoch(2, train=train,
                                                                          shuffle_seed=1))
    assert len(tep) == len(jep) > 0
    for (tids, tb), (jids, jb) in zip(tep, jep):
        assert tids == jids and tb.keys() == jb.keys() and "inputs2" in tb
        for k in tb:
            np.testing.assert_allclose(tb[k], jb[k], atol=TOL_FEATS, rtol=0)


def test_batcher_second_stream_matches_jax():
    rng = np.random.default_rng(0)
    n = 7
    arrays = ((rng.standard_normal((n, 5, 3)).astype(np.float32),
               rng.standard_normal((n, 5, 2)).astype(np.float32)),
              rng.integers(-1, 5, (n, 3)).astype(np.int32),
              rng.integers(0, 4, n).astype(np.int32), rng.integers(1, 6, n).astype(np.int32))
    ids = list(range(n))
    tb, jb = tbatcher.Batcher(*arrays, ids, ids[:6], ids[6:]), \
        jbatcher.Batcher(*arrays, ids, ids[:6], ids[6:])
    for (tids, t), (jids, j) in zip(tb.epoch(2, shuffle_seed=4), jb.epoch(2, shuffle_seed=4)):
        assert tids == jids and t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("family", ["early_fusion", "late_fusion"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_apply_tm_matches_jax(family, dtype, train, jax_streams, monkeypatch):
    """Both models' time-major logits against JAX's apply_tm, eval and
    train mode (the JAX masks and noise on the same paths), f32 and bf16."""
    cfg, sources = _family(family, dtype)
    jmodel, jparams, tmodel = pair(cfg, sources, seed=2)
    if dtype == "bfloat16":
        monkeypatch.setattr(jdispatch, "MODE", "pallas")
    batch = two_stream_batch(cfg, seed=3)
    key = prng.fold_in(prng.root_key(5), 1)
    inputs = (batch["inputs"], batch["inputs2"])
    apply = jax.jit(functools.partial(jmodel.apply_tm, train=train))
    want = np.asarray(apply(jparams, inputs, rng=jax_key(key) if train else None))
    with torch.no_grad():
        got = tmodel.apply_tm(tuple(torch.from_numpy(x) for x in inputs), train=train,
                              rng=key if train else None)
    assert got.shape == (T, B, cfg.nb_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LOGITS[dtype], rtol=0)
    drawn = [p[len(key.path):] for _, p in jax_streams]
    if not train:
        assert drawn == []
    elif family == "early_fusion":  # per-stream noise, then no encoder noise
        assert drawn == [("noise_a",), ("noise_s",), ("drop_0", 0), ("drop_0", 1),
                         ("drop_1", 0), ("drop_1", 1), ("head_drop",)]
    else:  # speech noise 0.5, skeletal 0.0: no draw
        assert drawn == [("enc_a", "noise"), ("enc_a", "drop_0", 0), ("enc_a", "drop_0", 1),
                         ("enc_a", "drop_1", 0), ("enc_a", "drop_1", 1),
                         ("enc_s", "drop_0", 0), ("enc_s", "drop_0", 1),
                         ("enc_s", "drop_1", 0), ("enc_s", "drop_1", 1),
                         ("fusion_drop", 0), ("fusion_drop", 1), ("head_drop",)]


def test_bridge_loads_a_jax_late_fusion_tree_bit_for_bit():
    cfg, sources = late_cfgs()
    jparams = jax.jit(jbuild(cfg, sources).init)(jprng.root_key(6))
    tmodel = bridge.load_params(tbuild(_port(cfg), {k: _port(v) for k, v in sources.items()}, device="cpu"),
                                jax.tree.map(np.array, jparams))
    flat = _flat(jparams)
    assert set(flat) == set(tmodel.state_dict())
    assert {k.split(".")[0] for k in flat} == {"speech", "skeletal", "fusion", "head"}
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flat[k])
    back = _flat(bridge.params_to_numpy(tmodel))
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


# -------------------------------------------------------------- train step


@pytest.mark.parametrize("family", ["early_fusion", "late_fusion"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(family, dtype, jax_streams, monkeypatch):
    """One train step: loss, every gradient (late fusion's frozen encoders
    exactly 0 in the port, as the JAX step's freeze mask makes them), the
    grad norm and the updated parameters."""
    cfg, sources = _family(family, dtype)
    jmodel, jparams, tmodel = pair(cfg, sources, seed=7)
    if dtype == "bfloat16":
        monkeypatch.setattr(jdispatch, "MODE", "pallas")
    batch = two_stream_batch(cfg, seed=8)
    key = prng.fold_in(prng.fold_name(prng.root_key(cfg.seed), "dropout"), 3)

    tx = jopt.keras_adam(cfg.optimizer)

    @jax.jit
    def jax_step(state, rng):  # make_train_step's body, with the gradients
        loss, grads = jstep._loss_and_grads(jmodel, state.params, batch, rng=rng)
        return grads, *jstep._apply_updates(jmodel, state, tx, loss, grads, 1.0)

    jstate = jstep.create_train_state(jmodel, jprng.root_key(7))._replace(params=jparams)
    jgrads, jnew, jm = jax_step(jstate, jax_key(key))

    tstate = tstep.create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    loss, tgrads = tstep._loss_and_grads(
        tmodel, tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()}, key)
    tgrads = {k: g.clone() for k, g in tgrads.items()}
    tstate, tm = tstep.make_train_step(tmodel)(tstate, batch, key, 1.0)

    jloss = float(jm["loss"])
    for got in (float(loss), float(tm["loss"])):
        assert abs(got - jloss) <= TOL_LOSS[dtype] * abs(jloss)
    frozen = {k for k, v in tmodel.trainable().items() if not v}
    assert frozen == ({k for k in tgrads if k.split(".")[0] in ("speech", "skeletal")}
                      if family == "late_fusion" else set())
    for k, want in _flat(jgrads).items():
        if k in frozen:
            assert not tgrads[k].any()
            continue
        rel = np.linalg.norm(tgrads[k].numpy() - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= TOL_GRAD[dtype], (k, rel)
    gn = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= TOL_GRAD[dtype] * gn
    lr = cfg.optimizer.learning_rate
    for k, want in _flat(jnew.params).items():
        if k in frozen:
            assert torch.equal(tstate.params[k].detach(), before[k])
            np.testing.assert_array_equal(before[k].numpy(), want)
        else:
            _params_close(tstate.params[k].detach().numpy(), want, 2 * lr)
            assert not torch.equal(tstate.params[k].detach(), before[k])


def _count_recurrences(monkeypatch):
    """Calls of the K1 and K2 wrappers (the plain versions run under them
    on the CPU): [store_c of each K1 call], number of K2 calls."""
    calls = {"k1": [], "k2": 0}
    streams, bwd = k1.bilstm_tm_streams, k1.bilstm_tm_bwd

    def count_streams(*a, store_c=False):
        calls["k1"].append(store_c)
        return streams(*a, store_c=store_c)

    def count_bwd(*a):
        calls["k2"] += 1
        return bwd(*a)

    monkeypatch.setattr(k1, "bilstm_tm_streams", count_streams)
    monkeypatch.setattr(k1, "bilstm_tm_bwd", count_bwd)
    return calls


def test_frozen_encoders_compute_no_backward(monkeypatch):
    """Late fusion with frozen encoders: autograd gives the encoders no
    .grad, the recurrence runs five times of which one (the fusion layer)
    stores its c stream, its adjoint once; the step's gradients for them
    are exact zeros and several steps leave them bit-unchanged. With
    ``finetune_encoders`` the same logits (the stored path gives the same
    h), five adjoints, and the encoders train."""
    cfg, sources = late_cfgs()
    _, _, frozen = pair(cfg, sources, seed=9)
    _, _, tuned = pair(cfg.replace(finetune_encoders=True), sources, seed=9)
    batch = {k: torch.from_numpy(v) for k, v in two_stream_batch(cfg, seed=10).items()}
    key = prng.fold_name(prng.root_key(1), "dropout")
    encoders = [k for k in frozen.state_dict() if k.split(".")[0] in ("speech", "skeletal")]

    logits = {}
    for tag, model in (("frozen", frozen), ("tuned", tuned)):
        calls = _count_recurrences(monkeypatch)
        with torch.enable_grad():
            loss = tstep._loss_from_batch(model, batch, train=True, rng=key)
            logits[tag] = model.apply_tm((batch["inputs"], batch["inputs2"]), train=True,
                                         rng=key).detach()
            calls["k1"].clear()
            loss.backward()
        params = dict(model.named_parameters())
        if tag == "frozen":
            assert all(params[k].grad is None for k in encoders)
        else:
            assert all(params[k].grad is not None for k in encoders)
        for p in model.parameters():
            p.grad = None
        monkeypatch.undo()
        calls = _count_recurrences(monkeypatch)
        loss, grads = tstep._loss_and_grads(model, dict(model.named_parameters()), batch, key)
        assert sorted(calls["k1"]) == ([False] * 4 + [True] if tag == "frozen" else [True] * 5)
        assert calls["k2"] == (1 if tag == "frozen" else 5)
        assert all(not grads[k].any() for k in encoders) == (tag == "frozen")
        monkeypatch.undo()
    assert torch.equal(logits["frozen"], logits["tuned"])

    for model, changes in ((frozen, False), (tuned, True)):
        state = tstep.create_train_state(model)
        start = {k: v.detach().clone() for k, v in state.params.items()}
        step = tstep.make_train_step(model)
        for i in range(3):
            state, m = step(state, batch, prng.fold_in(key, i))
        for k in encoders:
            assert torch.equal(state.params[k], start[k]) != changes, k
        assert not torch.equal(state.params["fusion.W"], start["fusion.W"])


# ---------------------------------------------------------------- the CLI


def _cli_early_cfg():
    """Early fusion at test size with noise and dropout off (the two
    packages' draws differ), f32."""
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                               output_dropout=0.0)
    return cfglib.get_preset("early_fusion").replace(
        maxlen=T, batch_size=2, max_label_len=N, encoder=enc, second_stream_noise=0.0,
        compute_dtype="float32", patience=50,
        optimizer=cfglib.OptimizerConfig(learning_rate=0.05))


def _run(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_early_fusion_cli_matches_jax_cli(corpus, tmp_path, capsys, monkeypatch):
    """`train early_fusion` through both CLIs on the same corpus and
    initial weights; then the JAX-trained weights, bridged into a port
    workdir, give the JAX CLI's `decode` MLF and `evaluate` metrics."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli import main as tcli
    from mgr_tpu_torch.models import zoo

    cfg = _cli_early_cfg()
    monkeypatch.setitem(cfglib.PRESETS, "early_fusion", lambda: cfg)
    monkeypatch.setitem(tconfig.PRESETS, "early_fusion", lambda: _port(cfg))
    init = jax.tree.map(np.array, jbuild(cfg).init(jprng.root_key(cfg.seed)))
    real_build = zoo.build_model
    monkeypatch.setattr(zoo, "build_model", lambda c, *a, **kw: bridge.load_params(
        real_build(c, *a, **kw), init))
    data = ["--audio-csv", corpus["audio_csv"], "--skeletal-csv", corpus["sk_csv"]]
    dirs = {tag: str(tmp_path / tag) for tag in ("jax", "torch")}
    outs = {}
    for tag, main, dev in (("jax", jmain, []), ("torch", tcli.main, ["--device", "cpu"])):
        outs[tag] = _run(capsys, main, ["train", "early_fusion", "--workdir", dirs[tag],
                                        "--epochs", "4", *dev, *data])
    assert outs["torch"]["epochs_run"] == outs["jax"]["epochs_run"] == 4
    assert outs["torch"]["best_val_loss"] == pytest.approx(outs["jax"]["best_val_loss"],
                                                           rel=1e-4)
    jcfg = json.load(open(f"{dirs['jax']}/early_fusion_config.json"))
    assert json.load(open(f"{dirs['torch']}/early_fusion_config.json")) == jcfg

    # The same (JAX-trained) weights in both workdirs.
    jmodel = jbuild(cfg)
    trained = jloop.load_params_for_eval(jmodel, dirs["jax"], slot="best")
    same = str(tmp_path / "same")
    tckpt.save_config(same, "early_fusion", _port(cfg))
    tckpt.save_params(same, "early_fusion",
                      bridge.load_params(real_build(_port(cfg), device="cpu"), jax.tree.map(np.array, trained)))
    got = {}
    for tag, main, wd, dev in (("jax", jmain, dirs["jax"], []),
                               ("torch", tcli.main, same, ["--device", "cpu"])):
        mlf = str(tmp_path / f"{tag}.mlf")
        dec = _run(capsys, main, ["decode", "early_fusion", "--workdir", wd, "--out", mlf,
                                  *dev, *data])
        ev = _run(capsys, main, ["evaluate", "early_fusion", "--workdir", wd, "--dataset",
                                 "val", *dev, *data])
        got[tag] = (dec["decoded"], open(mlf).read(), ev)
    assert got["torch"] == got["jax"] and got["torch"][0] == 10
    assert "sil" in got["torch"][1]  # the trained blank clears 0.97 somewhere
    assert jckpt.has_checkpoint(dirs["jax"], "early_fusion", "best")
