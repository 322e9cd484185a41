"""The rgb family of the port (the CNN frontend, the residual BLSTM on its
frame features, the head) held against the JAX package's: the frontend's
geometry and values, the model's logits with and without remat, one train
step, the video readers and ``LazyVideoBatcher`` batches, the bridge of a
JAX rgb tree, and `train`/`decode`/`evaluate`/`infer rgb` through both CLIs.

The models run at img_dim 44 (44 -> 40 -> 20 -> 16 -> 8 -> 5 -> 2: a 2x2x8
map), where a flatten in another order than JAX's (h, w, c) would show;
the frontend is also held at img_dim 36, whose map is 1x1. bf16 runs JAX
with ``mgr_tpu.ops.dispatch.MODE = "pallas"`` (the Pallas kernels in
interpret mode), f32 its XLA path.

Tolerances, each with its reason:
  * frontend features: f32 1e-5 absolute (f32 sums of at most 96 products
    in another order); bf16 3e-2 (each block's output and bias add round
    to bf16, one bf16 ulp of a feature is ~4e-3).
  * logits: f32 1e-4 absolute, bf16 3e-2 (bf16 h streams), as the other
    families are held; remat changes no bit.
  * train step: loss 1e-3 relative, every gradient (``cnn.*`` included)
    5e-2 relative Frobenius (bf16 convs and their transposes, bf16 dz);
    the updated parameters as ``test_torch_train._params_close``.
  * video batches, labels, lengths, split ids: exactly.
  * CLI: best losses 1e-4 relative; config, plateau state, MLF, metrics
    and tokens equal.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.data import formats as jformats
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.models import layers as jlayers
from mgr_tpu.ops import dispatch as jdispatch
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import formats as tformats
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.models import layers as tlayers
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.train import step as tstep
from test_torch_train import _params_close

torch.set_num_threads(1)

T, B, N, D = 6, 2, 3, 44
CNN = cfglib.CNNConfig(img_dim=D, channels=(4, 6, 8))
CNN_36 = cfglib.CNNConfig(img_dim=36, channels=(4, 6, 8))
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL_FEATS = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_LOSS_REL = 1e-3
TOL_GRAD_REL = 5e-2


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def rgb_cfg(dtype="float32", remat=True, **kw):
    """The rgb preset at test size: its structure (no noise, no dropout,
    22 classes, trim 2, the plateau controller) with a narrow CNN and
    BiLSTM(8)x2."""
    return cfglib.get_preset("rgb").replace(
        maxlen=T, batch_size=B, max_label_len=N, compute_dtype=dtype,
        cnn=cfglib.CNNConfig(img_dim=D, channels=(4, 6, 8), remat=remat),
        encoder=cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                                     output_dropout=0.0), **kw)


def pair(cfg, seed=0):
    """The JAX model and the port's on the same weights: the port's seeded
    init, carried to JAX by the bridge."""
    tmodel = tbuild(_port(cfg), seed=seed, device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tmodel))
    return jbuild(cfg), jparams, tmodel


def video(seed, n=B, d=D):
    """Normalised pixels, as a batch carries them."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 256, (n, T, d, d, 1)) - 128.0) / 255.0).astype(np.float32)


def video_batch(cfg, seed=1):
    rng = np.random.default_rng(seed + 100)
    lab_len = np.array([2, 0], np.int32)
    labels = np.full((B, N), -1, np.int32)
    labels[0, :2] = rng.integers(0, cfg.nb_classes - 1, size=2)
    return {"inputs": video(seed), "labels": labels,
            "input_length": np.full((B,), T - cfg.ctc.trim_frames, np.int32),
            "label_length": lab_len}


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(tree).items()}


# ------------------------------------------------------------ the frontend


@pytest.mark.parametrize("cnn,want", [(cfglib.CNNConfig(), 768), (CNN_36, 8), (CNN, 32),
                                      (cfglib.CNNConfig(img_dim=30, kernel_sizes=(3, 3, 3),
                                                        pool_sizes=(1, 2, 2)), 1200)])
def test_cnn_output_dim_matches_jax(cnn, want):
    assert tlayers.cnn_output_dim(_port_cnn(cnn)) == jlayers.cnn_output_dim(cnn) == want


def _port_cnn(cnn):
    return tconfig.CNNConfig(**{k: getattr(cnn, k) for k in cnn.__dataclass_fields__})


@pytest.mark.parametrize("cnn", [CNN, CNN_36], ids=["img44", "img36"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cnn_frontend_matches_jax(cnn, dtype):
    """(B, T, D, D, 1) -> (B, T, features) f32 on the same HWIO kernels,
    drawn 4x the init's scale so that the features are of order 1, and
    nonzero biases (the compute-dtype bias add is held too)."""
    tdt, jdt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    params = tlayers.init_cnn(gen, _port_cnn(cnn))
    for i, c in enumerate(cnn.channels):
        params[f"conv_{i}"] *= 4.0
        params[f"bias_{i}"] = 0.1 * torch.randn((c,), generator=gen)
    x = video(4, d=cnn.img_dim)
    got = tlayers.cnn_frontend(params, torch.from_numpy(x), _port_cnn(cnn), tdt)
    front = jax.jit(functools.partial(jlayers.cnn_frontend, cfg=cnn, compute_dtype=jdt))
    want = np.asarray(front({k: jnp.asarray(v.numpy()) for k, v in params.items()}, x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        B, T, jlayers.cnn_output_dim(cnn))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FEATS[dtype], rtol=0)
    assert np.abs(want).max() > 0.5  # not a comparison of near-zeros


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, False])
def test_rgb_model_matches_jax(dtype, remat, monkeypatch):
    """apply_tm's (T, B, C) and forward's (B, T, C) logits against JAX's
    apply_tm (and its transpose, JAX's apply), eval mode. With remat and grad enabled the port's
    frontend runs under torch.utils.checkpoint (once per call), with the
    same values to the bit; without grad, or without remat, it does not."""
    cfg = rgb_cfg(dtype, remat=remat)
    jmodel, jparams, tmodel = pair(cfg, seed=2)
    if dtype == "bfloat16":
        monkeypatch.setattr(jdispatch, "MODE", "pallas")
    x = video(5)
    want_tm = np.asarray(jax.jit(jmodel.apply_tm)(jparams, x))
    want = want_tm.swapaxes(0, 1)  # JAX's apply is apply_tm's transpose
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got_tm, got = tmodel.apply_tm(xt), tmodel(xt)
    assert calls == []
    with torch.enable_grad():
        graded = tmodel.apply_tm(xt)
    assert len(calls) == (1 if remat else 0)
    assert torch.equal(graded.detach(), got_tm)
    assert got_tm.shape == (T, B, cfg.nb_classes) and got_tm.dtype == torch.float32
    np.testing.assert_allclose(got_tm.numpy(), want_tm, atol=TOL_LOGITS[dtype], rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LOGITS[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgb_train_step_matches_jax(dtype, monkeypatch):
    """One train step (remat on, as the preset): loss, every gradient
    (the three conv kernels and biases included), the grad norm and the
    updated parameters."""
    cfg = rgb_cfg(dtype)
    jmodel, jparams, tmodel = pair(cfg, seed=7)
    if dtype == "bfloat16":
        monkeypatch.setattr(jdispatch, "MODE", "pallas")
    batch = video_batch(cfg, seed=8)
    tx = jopt.keras_adam(cfg.optimizer)

    @jax.jit
    def jax_step(state):  # make_train_step's body, with the gradients
        loss, grads = jstep._loss_and_grads(jmodel, state.params, batch, rng=None)
        return grads, *jstep._apply_updates(jmodel, state, tx, loss, grads, 1.0)

    jstate = jstep.create_train_state(jmodel, jprng.root_key(7))._replace(params=jparams)
    jgrads, jnew, jm = jax_step(jstate)

    tstate = tstep.create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    loss, tgrads = tstep._loss_and_grads(
        tmodel, tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    tgrads = {k: g.clone() for k, g in tgrads.items()}
    tstate, tm = tstep.make_train_step(tmodel)(tstate, batch, None, 1.0)

    jloss = float(jm["loss"])
    for got in (float(loss), float(tm["loss"])):
        assert abs(got - jloss) <= TOL_LOSS_REL * abs(jloss)
    want_grads = _flat(jgrads)
    assert {f"cnn.{p}_{i}" for p in ("conv", "bias") for i in range(3)} <= set(want_grads)
    for k, want in want_grads.items():
        rel = np.linalg.norm(tgrads[k].numpy() - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= TOL_GRAD_REL, (k, rel)
        assert np.linalg.norm(want) > 0, k
    gn = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= TOL_GRAD_REL * gn
    lr = cfg.optimizer.learning_rate
    for k, want in _flat(jnew.params).items():
        _params_close(tstate.params[k].detach().numpy(), want, 2 * lr)
        assert not torch.equal(tstate.params[k].detach(), before[k])


# ----------------------------------------------------------------- corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten videos of 4 frames a label (1-2 labels: shorter and longer than
    T=6), plus a 3-D (T, D, D) video."""
    root = str(tmp_path_factory.mktemp("torch_rgb"))
    data_dir, label_file, labels = synthetic.make_rgb_dataset(
        root, n_files=10, img_dim=D, frames_per_label=4, max_labels=2, seed=5)
    flat = os.path.join(root, "Sample00042_color.npy")
    np.save(flat, np.random.default_rng(0).integers(0, 256, (3, D, D)).astype(np.uint8))
    return dict(data_dir=data_dir, labels=label_file, flat=flat)


def test_video_readers_match_jax(corpus):
    names = tformats.list_video_files(corpus["data_dir"])
    assert names == jformats.list_video_files(corpus["data_dir"]) and len(names) == 10
    assert [tformats.video_file_id(n) for n in names] == \
        [jformats.video_file_id(n) for n in names] == list(range(1, 11))
    for path in [os.path.join(corpus["data_dir"], n) for n in names[:3]] + [corpus["flat"]]:
        t, j = tformats.load_video_npy(path), jformats.load_video_npy(path)
        assert t.dtype == j.dtype == np.float32 and t.shape == j.shape and t.ndim == 4
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", ["train", "val", "final"])
def test_rgb_dataset_matches_jax(corpus, mode):
    """Split ids, labels and lengths; then every batch of each split, for
    one process and for each of two processes striding the batches:
    inputs, labels and lengths bit-equal."""
    kw = dict(maxlen=T, max_label_len=N, batch_size=2, cnn=CNN)
    tcfg, jcfg = tconfig.get_preset("rgb", **{**kw, "cnn": _port_cnn(CNN)}), \
        cfglib.get_preset("rgb", **kw)
    src = (corpus["data_dir"], corpus["labels"])
    t = tdatasets.build_rgb_dataset(*src, tcfg, mode=mode)
    j = jdatasets.build_rgb_dataset(*src, jcfg, mode=mode)
    assert (t.file_ids, t.train_ids, t.val_ids) == (j.file_ids, j.train_ids, j.val_ids)
    for k in ("labels", "label_lengths", "input_lengths"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    splits = (True, False) if mode == "train" else (False,)
    for train in splits:
        for pi, pc in ((0, 1), (0, 2), (1, 2)):
            kw = dict(train=train, shuffle_seed=3 if train else None, process_index=pi,
                      process_count=pc)
            tep, jep = list(t.epoch(2, **kw)), list(j.epoch(2, **kw))
            assert len(tep) == len(jep) == len(range(pi, t.num_batches(2, train), pc))
            for (tids, tb), (jids, jb) in zip(tep, jep):
                assert tids == jids and tb.keys() == jb.keys()
                assert tb["inputs"].shape == (2, T, D, D, 1) and tb["inputs"].dtype == np.float32
                for k in tb:
                    np.testing.assert_array_equal(tb[k], jb[k])
    if mode == "final":
        assert (t.label_lengths == 1).all()


# -------------------------------------------------------------------- CLI


def _cli_cfg():
    """rgb at test size in f32, lr 0.05, and a plateau controller that
    fires within four epochs (patience 1, min_delta 10 on the train loss,
    cooldown 2 as the preset)."""
    return rgb_cfg(patience=50, reduce_lr_patience=1,
                   reduce_lr_min_delta=10.0,
                   optimizer=cfglib.OptimizerConfig(learning_rate=0.05))


def _run(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rgb_cli_matches_jax_cli(corpus, tmp_path, capsys, monkeypatch):
    """The JAX init of a tiny rgb model loads into the port bit for bit
    (HWIO conv kernels and all); `train rgb` through both CLIs on the same
    corpus and those initial weights: the same best loss and plateau
    state; then the JAX-trained
    weights, bridged into a port workdir, give the JAX CLI's `decode` MLF,
    `evaluate` metrics and `infer` tokens."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli import main as tcli
    from mgr_tpu_torch.models import zoo

    cfg = _cli_cfg()
    monkeypatch.setitem(cfglib.PRESETS, "rgb", lambda: cfg)
    monkeypatch.setitem(tconfig.PRESETS, "rgb", lambda: _port(cfg))
    init = jax.tree.map(np.array, jax.jit(jbuild(cfg).init)(jprng.root_key(cfg.seed)))
    real_build = zoo.build_model
    loaded, flat = bridge.load_params(real_build(_port(cfg), device="cpu"), init).state_dict(), _flat(init)
    assert set(flat) == set(loaded) and flat["cnn.conv_1"].shape == (5, 5, 4, 6)
    assert all(np.array_equal(v.numpy(), flat[k]) for k, v in loaded.items())  # bit for bit
    monkeypatch.setattr(zoo, "build_model", lambda c, *a, **kw: bridge.load_params(
        real_build(c, *a, **kw), init))
    data = ["--data-dir", corpus["data_dir"], "--labels", corpus["labels"]]
    dirs = {tag: str(tmp_path / tag) for tag in ("jax", "torch")}
    outs = {}
    for tag, main, dev in (("jax", jmain, []), ("torch", tcli.main, ["--device", "cpu"])):
        outs[tag] = _run(capsys, main, ["train", "rgb", "--workdir", dirs[tag], "--epochs", "4",
                                        *dev, *data])
    assert outs["torch"]["epochs_run"] == outs["jax"]["epochs_run"] == 4
    assert outs["torch"]["best_val_loss"] == pytest.approx(outs["jax"]["best_val_loss"],
                                                           rel=1e-4)
    meta = {tag: json.load(open(f"{d}/rgb_fitmeta.json")) for tag, d in dirs.items()}
    assert meta["torch"]["plateau"]["scale"] == meta["jax"]["plateau"]["scale"] == 0.5
    assert meta["torch"]["plateau"] == pytest.approx(meta["jax"]["plateau"], rel=1e-4)
    jcfg = json.load(open(f"{dirs['jax']}/rgb_config.json"))
    assert json.load(open(f"{dirs['torch']}/rgb_config.json")) == jcfg

    trained = jloop.load_params_for_eval(jbuild(cfg), dirs["jax"], slot="best")
    same = str(tmp_path / "same")
    tckpt.save_config(same, "rgb", _port(cfg))
    tckpt.save_params(same, "rgb",
                      bridge.load_params(real_build(_port(cfg), device="cpu"), jax.tree.map(np.array, trained)))
    one = os.path.join(corpus["data_dir"], "Sample00003_color.npy")
    got = {}
    for tag, main, wd, dev in (("jax", jmain, dirs["jax"], []),
                               ("torch", tcli.main, same, ["--device", "cpu"])):
        mlf = str(tmp_path / f"{tag}.mlf")
        dec = _run(capsys, main, ["decode", "rgb", "--workdir", wd, "--out", mlf, *dev, *data])
        ev = _run(capsys, main, ["evaluate", "rgb", "--workdir", wd, "--dataset", "val",
                                 *dev, *data])
        inf = _run(capsys, main, ["infer", "rgb", one, "--workdir", wd, *dev])
        got[tag] = (dec["decoded"], open(mlf).read(), ev, inf["tokens"])
    assert got["torch"] == got["jax"] and got["torch"][0] == 10 and got["torch"][3]
