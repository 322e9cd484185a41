"""The port reads the JAX package's checkpoints: flax msgpack slots
written by ``mgr_tpu.core.checkpoint`` (real ones, from JAX fits and
``save_checkpoint`` in this process), through ``mgr_tpu_torch.core.msgpack``
(a decoder written from the spec) and ``core.checkpoint``'s JAX readers.

Held: every leaf as flax restores it; a trained speech and skeletal
``TrainState`` (params, step, Adam's mu, nu and counts) and an rgb state
(HWIO conv kernels) bit for bit; optax's ``apply_if_finite`` layout and
the flexible fallback when ``skip_nonfinite`` was toggled; a resume of a
JAX workdir (the losses of JAX's own resume, 1e-4 relative: f32 sums in
another order); ``decode``/``evaluate``/``infer``/``train --resume`` on a
workdir of msgpack slots (JAX's MLF, metrics and tokens, equal); the
late-fusion graft of JAX-trained encoders (bit for bit); flax's chunked
arrays and bfloat16; malformed input raises.
"""

import json
import logging
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack as msgpack_lib
import numpy as np
import pytest
import torch
from flax import serialization

from mgr_tpu.core import checkpoint as jckpt
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import msgpack
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.models import zoo
from mgr_tpu_torch.train import loop as tloop
from mgr_tpu_torch.train import step as tstep

torch.set_num_threads(1)

T = 24
TOL_F32 = 1e-4
OFF = dict(input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0)


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _configs():
    """speech, skeletal and late fusion at test size, f32, dropout and
    noise off, batch 2."""
    common = dict(maxlen=T, batch_size=2, compute_dtype="float32", patience=50,
                  optimizer=cfglib.OptimizerConfig(learning_rate=0.05, decay=1e-5))
    return {
        "speech": cfglib.get_preset("speech").replace(
            max_label_len=12, encoder=cfglib.EncoderConfig(hidden=8, depth=2, **OFF), **common),
        "skeletal": cfglib.get_preset("skeletal").replace(
            max_label_len=4, encoder=cfglib.EncoderConfig(hidden=6, depth=2, **OFF), **common),
        "late_fusion": cfglib.get_preset("late_fusion").replace(
            max_label_len=4, fusion_hidden=4, fusion_dropout=0.0, fusion_output_dropout=0.0,
            encoder=cfglib.EncoderConfig(hidden=8, depth=2, **OFF), **common),
    }


def _datasets(corpus, cfgs, jax_side):
    ds = jdatasets if jax_side else tdatasets
    conv = (lambda c: c) if jax_side else _port
    return {"speech": ds.build_audio_dataset(corpus["audio_dir"], corpus["audio_labels"],
                                             conv(cfgs["speech"])),
            "skeletal": ds.build_skeletal_dataset(corpus["sk_csv"], corpus["labels"],
                                                  conv(cfgs["skeletal"]))}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX workdir: speech and skeletal trained 2 epochs each by the JAX
    fit (msgpack slots, config, fitmeta), and the corpus they trained on."""
    root = tmp_path_factory.mktemp("torch_msgpack")
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        str(root), n_files=10, frames_per_label=6, seed=7)
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        str(root), labels=labels, frames_per_label=30, seed=8)
    corpus = dict(sk_csv=sk_csv, labels=sk_labels, audio_dir=audio_dir,
                  audio_labels=audio_labels)
    cfgs = _configs()
    wd = str(root / "jax")
    data = _datasets(corpus, cfgs, jax_side=True)
    results = {name: jloop.fit(jbuild(cfgs[name]), data[name], workdir=wd, epochs=2)
               for name in ("speech", "skeletal")}
    return dict(corpus=corpus, cfgs=cfgs, wd=wd, results=results)


def _leaves_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _leaves_equal(got[k], want[k])
        return
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):  # bfloat16: compare the bits
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(), want.view(np.uint16))
        return
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in bridge.flatten(tree).items()}


def _assert_state(tstate, jstate_params, step, adam, notfinite=(0, 0)):
    for k, v in _flat_np(jstate_params).items():
        np.testing.assert_array_equal(tstate.params[k].detach().numpy(), v)
    assert tstate.step == int(step)
    for field in ("mu", "nu"):
        got = getattr(tstate.opt_state, field)
        for k, v in _flat_np(getattr(adam, field)).items():
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert int(tstate.opt_state.count) == int(adam.count)
    assert (int(tstate.opt_state.notfinite_count), int(tstate.opt_state.total_notfinite)) == \
        notfinite


# ------------------------------------------------------------------ the format


def test_every_leaf_reads_as_flax_restores_it(jax_run):
    for name in ("speech", "skeletal"):
        for slot in ("best", "latest"):
            raw = open(tckpt.jax_slot_path(jax_run["wd"], name, slot), "rb").read()
            _leaves_equal(tckpt.read_jax_checkpoint(jax_run["wd"], name, slot=slot),
                          serialization.msgpack_restore(raw))


@pytest.mark.parametrize("name", ["speech", "skeletal"])
def test_a_jax_trained_state_loads_bit_for_bit(jax_run, name):
    """The latest slot of a JAX fit into the port's train state: the
    parameters, the step, Adam's moments and counts of JAX's final state."""
    cfg = jax_run["cfgs"][name]
    want = jax_run["results"][name].state
    state = tstep.create_train_state(zoo.build_model(_port(cfg), seed=9, device="cpu"))
    state = tckpt.load_jax_train_state(jax_run["wd"], name, state)
    _assert_state(state, want.params, want.step, want.opt_state[1])
    assert int(state.opt_state.schedule_count) == int(want.opt_state[2].count) == want.step
    assert tckpt.has_checkpoint(jax_run["wd"], name, "best")
    assert not tckpt.has_checkpoint(jax_run["wd"], name, "other")
    best = tckpt.read_params(jax_run["wd"], name, slot="best")
    jbest = jckpt.load_checkpoint(jax_run["wd"], name, want, slot="best")
    for k, v in _flat_np(jbest.params).items():
        np.testing.assert_array_equal(best[k].numpy(), v)


def _adam_state(cfg, params, step, seed):
    """optax's state of keras_adam with moments drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    opt = jopt.keras_adam(cfg.optimizer).init(params)
    chain = opt.inner_state if cfg.optimizer.skip_nonfinite else opt

    def draw(x):
        return rng.standard_normal(np.shape(x)).astype(np.float32)

    adam = chain[1]._replace(count=np.int32(step), mu=jax.tree.map(draw, params),
                             nu=jax.tree.map(lambda x: np.abs(draw(x)), params))
    chain = (chain[0], adam, chain[2]._replace(count=np.int32(step)))
    if cfg.optimizer.skip_nonfinite:
        return opt._replace(inner_state=chain, notfinite_count=np.int32(2),
                            total_notfinite=np.int32(5)), adam
    return chain, adam


def test_an_rgb_state_keeps_its_hwio_kernels(tmp_path):
    cfg = cfglib.get_preset("rgb").replace(
        maxlen=T, batch_size=2, max_label_len=4,
        cnn=cfglib.CNNConfig(img_dim=44, channels=(4, 6, 8)),
        encoder=cfglib.EncoderConfig(hidden=8, depth=2, **OFF))
    params = bridge.params_to_numpy(zoo.build_model(_port(cfg), seed=3, device="cpu"))
    opt, adam = _adam_state(cfg, params, 7, seed=4)
    jckpt.save_checkpoint(str(tmp_path), "rgb", jstep.TrainState(np.int32(7), params, opt))
    model = zoo.build_model(_port(cfg), seed=5, device="cpu")
    state = tckpt.load_train_state(str(tmp_path), "rgb", tstep.create_train_state(model))
    _assert_state(state, params, 7, adam)
    assert tuple(model.state_dict()["cnn.conv_0"].shape) == params["cnn"]["conv_0"].shape == \
        (5, 5, 1, 4)


def test_apply_if_finite_layout_and_the_flexible_fallback(tmp_path, caplog):
    """A state saved inside apply_if_finite loads with its counters; when
    the resuming config toggles skip_nonfinite, params and step load,
    the moments stay fresh and the schedule count is the step, with the
    warning of the JAX package's flexible restore."""
    base = _configs()["skeletal"]
    wrapped = base.replace(optimizer=cfglib.OptimizerConfig(skip_nonfinite=3, decay=1e-5))
    params = bridge.params_to_numpy(zoo.build_model(_port(base), seed=3, device="cpu"))
    for tag, cfg in (("plain", base), ("wrapped", wrapped)):
        opt, adam = _adam_state(cfg, params, 30_000, seed=6)
        jckpt.save_checkpoint(str(tmp_path / tag), "skeletal",
                              jstep.TrainState(np.int32(30_000), params, opt))

    def load(tag, cfg):
        model = zoo.build_model(_port(cfg), seed=8, device="cpu")
        return tckpt.load_train_state(str(tmp_path / tag), "skeletal",
                                      tstep.create_train_state(model),
                                      skip_nonfinite=cfg.optimizer.skip_nonfinite)

    with caplog.at_level(logging.WARNING):
        same = load("wrapped", wrapped)
    assert not caplog.records
    _assert_state(same, params, 30_000, _adam_state(wrapped, params, 30_000, seed=6)[1],
                  notfinite=(2, 5))
    for saved, cfg in (("plain", wrapped), ("wrapped", base)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got = load(saved, cfg)
            template = jstep.create_train_state(jbuild(cfg), jprng.root_key(1))
            want = jckpt.load_checkpoint_flexible(str(tmp_path / saved), "skeletal", template)
        msgs = [r.getMessage() for r in caplog.records]
        assert len(msgs) == 2 and all("optimizer state layout mismatch" in m and
                                      "count rewound to step 30000" in m for m in msgs)
        assert got.step == int(want.step) == 30_000
        for k, v in _flat_np(want.params).items():
            np.testing.assert_array_equal(got.params[k].detach().numpy(), v)
        assert int(got.opt_state.count) == 0 and int(got.opt_state.schedule_count) == 30_000
        assert all(not v.any() for v in got.opt_state.mu.values())
    bad = zoo.build_model(_port(base.replace(encoder=cfglib.EncoderConfig(hidden=7))),
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_train_state(str(tmp_path / "plain"), "skeletal",
                               tstep.create_train_state(bad))


# ------------------------------------------------------------------ a JAX workdir


def test_resume_of_a_jax_workdir_gives_the_losses_of_jax_resume(jax_run, tmp_path):
    cfg = jax_run["cfgs"]["skeletal"]
    for tag in ("jax", "torch"):
        shutil.copytree(jax_run["wd"], tmp_path / tag)
    jdata = _datasets(jax_run["corpus"], jax_run["cfgs"], jax_side=True)["skeletal"]
    tdata = _datasets(jax_run["corpus"], jax_run["cfgs"], jax_side=False)["skeletal"]
    want = jloop.fit(jbuild(cfg), jdata, workdir=str(tmp_path / "jax"), resume=True, epochs=4)
    got = tloop.fit(zoo.build_model(_port(cfg), seed=9, device="cpu"), tdata,
                    workdir=str(tmp_path / "torch"), resume=True, epochs=4)
    assert got.epochs_run == want.epochs_run == 2
    assert [h["epoch"] for h in got.history] == [2, 3]
    for key in ("train_loss", "val_loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got.history],
                                   [h[key] for h in want.history], rtol=TOL_F32, err_msg=key)
    assert got.best_val_loss == pytest.approx(want.best_val_loss, rel=TOL_F32)


def test_decode_evaluate_infer_and_resume_serve_a_jax_workdir(jax_run, tmp_path, capsys,
                                                               monkeypatch):
    """The port's CLI on a workdir of the JAX config, fitmeta and msgpack
    slots: decode writes JAX's MLF, evaluate its metrics, infer its tokens;
    train --resume continues from the JAX latest slot."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli.main import main as tmain

    c = jax_run["corpus"]
    wd = str(tmp_path / "wd")
    shutil.copytree(jax_run["wd"], wd)
    data = ["--skeletal-csv", c["sk_csv"], "--labels", c["labels"]]

    def run(main, argv):
        assert main(argv) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    got = {}
    for tag, main, dev in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        mlf = str(tmp_path / f"{tag}.mlf")
        dec = run(main, ["decode", "skeletal", "--workdir", wd, "--out", mlf, *dev, *data])
        ev = run(main, ["evaluate", "skeletal", "--workdir", wd, "--dataset", "val",
                        *dev, *data])
        inf = run(main, ["infer", "skeletal", c["sk_csv"], "--workdir", wd, *dev])
        got[tag] = (dec["decoded"], open(mlf).read(), ev, inf)
    assert got["torch"] == got["jax"] and got["torch"][0] == 10

    monkeypatch.setitem(tconfig.PRESETS, "skeletal", lambda: _port(jax_run["cfgs"]["skeletal"]))
    res = run(tmain, ["train", "skeletal", "--workdir", wd, "--epochs", "3", "--resume",
                      "--device", "cpu", *data])
    assert res["epochs_run"] == 1
    assert tckpt.load_fit_meta(wd, "skeletal")["num_train_batches"] == \
        json.load(open(f"{jax_run['wd']}/skeletal_fitmeta.json"))["num_train_batches"]


def test_train_late_fusion_grafts_jax_trained_encoders_bit_for_bit(jax_run, tmp_path,
                                                                   capsys, monkeypatch):
    """`train late_fusion` on a workdir whose speech and skeletal slots
    the JAX fit wrote: the fusion model's frozen encoders are those
    slots' encoders, bit for bit, before and after training."""
    from mgr_tpu_torch.cli.main import main as tmain
    from mgr_tpu_torch.train import curriculum

    for name, cfg in jax_run["cfgs"].items():
        monkeypatch.setitem(tconfig.PRESETS, name, lambda c=cfg: _port(c))
    c = jax_run["corpus"]
    wd = str(tmp_path / "wd")
    shutil.copytree(jax_run["wd"], wd)
    donors = {name: serialization.msgpack_restore(
        open(tckpt.jax_slot_path(wd, name, "best"), "rb").read())["params"]["encoder"]
        for name in ("speech", "skeletal")}

    def assert_grafted(params):
        for name, enc in donors.items():
            for k, v in _flat_np(enc).items():
                np.testing.assert_array_equal(params[f"{name}.{k}"].detach().numpy(), v)

    assert_grafted(curriculum.build_fusion_with_pretrained(wd, device="cpu").state_dict())
    assert tmain(["train", "late_fusion", "--workdir", wd, "--epochs", "1", "--device", "cpu",
                  "--audio-dir", c["audio_dir"], "--skeletal-csv", c["sk_csv"],
                  "--labels", c["labels"]]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["epochs_run"] == 1
    assert_grafted(tckpt.read_params(wd, "late_fusion", slot="latest"))


# ------------------------------------------------------------------ the decoder


def test_chunked_arrays_and_bfloat16_are_reassembled(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(4, 25),
            "b": {"c": np.asarray(jnp.linspace(-3, 3, 50, dtype=jnp.bfloat16)).reshape(5, 10),
                  "d": np.int32(7), "e": np.zeros((0, 3), np.float64)}}
    raw = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    got = msgpack.restore(raw)
    _leaves_equal(got, serialization.msgpack_restore(raw))
    assert got["b"]["c"].dtype == torch.bfloat16 and tuple(got["b"]["c"].shape) == (5, 10)


def test_the_decoder_reads_every_form_as_msgpack_does():
    values = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63,
              1.5, -1e300, "", "x" * 31, "x" * 32, "é" * 300, "y" * 70000, b"", b"z" * 300,
              b"z" * 70000, list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): [i] for i in range(70000)},
              complex(1.5, -2.0)]
    ext = {1: 1, 2: 2, 4: 4, 8: 8, 16: 16, 3: 3, 300: 300, 70000: 70000}
    for v in values:
        raw = serialization.msgpack_serialize({"v": v}) if isinstance(v, complex) else \
            msgpack_lib.packb(v, use_bin_type=True)
        want = serialization.msgpack_restore(raw) if isinstance(v, complex) else \
            msgpack_lib.unpackb(raw, raw=False, strict_map_key=False)
        got = msgpack.restore(raw)
        assert got == want, repr(v)[:40]
    assert msgpack.unpackb(msgpack_lib.packb(1.5, use_single_float=True)) == 1.5
    for n in ext:
        raw = msgpack_lib.packb(msgpack_lib.ExtType(5, b"q" * n))
        assert msgpack.unpackb(raw, ext_hook=lambda code, data: (code, data)) == (5, b"q" * n)


def _ext(code, payload):
    return msgpack_lib.packb({"x": msgpack_lib.ExtType(code, payload)})


def _ndarray_payload(shape, dtype, raw):
    return msgpack_lib.packb((shape, dtype, raw), use_bin_type=True)


@pytest.mark.parametrize("raw,match", [
    (_ext(7, b"\x00"), "ext type 7"),
    (_ext(1, _ndarray_payload((2,), "float8_e4m3fn", b"\x00\x00")), "dtype 'float8_e4m3fn'"),
    (_ext(1, _ndarray_payload((2,), "object", b"\x00" * 16)), "dtype 'object'"),
    (_ext(1, _ndarray_payload((3,), "float32", b"\x00" * 8)), "holds 12 bytes"),
    (_ext(1, msgpack_lib.packb([1, 2])), "not \\[shape, dtype, bytes\\]"),
    (serialization.msgpack_serialize({"a": np.ones(4, np.float32)})[:-5], "truncated"),
    (b"\x81\xa1a\xc1", "0xc1"),
    (msgpack_lib.packb(1) + b"\x00", "after the value"),
    (msgpack_lib.packb({(1, 2): 3}, use_bin_type=True), "map key"),
])
def test_malformed_input_raises(raw, match):
    with pytest.raises(ValueError, match=match):
        msgpack.restore(raw)


def test_the_smoke_scripts_packer_writes_a_slot_jax_reads(tmp_path):
    """chip_smoke.py writes its msgpack slot with its own packer (the GPU
    host has no flax): JAX's load_checkpoint restores it into its own
    TrainState, bit for bit."""
    cfg = _configs()["skeletal"]
    state = tstep.create_train_state(zoo.build_model(_port(cfg), seed=3, device="cpu"))
    rng = np.random.default_rng(5)
    state.step = 17
    for moments in (state.opt_state.mu, state.opt_state.nu):
        for k, v in moments.items():
            moments[k] = torch.from_numpy(rng.random(tuple(v.shape), dtype=np.float32))
    state.opt_state.count = torch.tensor(17, dtype=torch.int32)
    state.opt_state.schedule_count = torch.tensor(17, dtype=torch.int32)
    tckpt.save_train_state(str(tmp_path), "skeletal", state)
    code = ("import chip_smoke as cs; "
            f"open({tckpt.jax_slot_path(str(tmp_path), 'skeletal')!r}, 'wb').write("
            f"cs._jax_slot({tckpt.state_path(str(tmp_path), 'skeletal')!r}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    template = jstep.create_train_state(jbuild(cfg), jprng.root_key(0))
    got = jckpt.load_checkpoint(str(tmp_path), "skeletal", template)
    assert int(got.step) == 17
    for k, v in _flat_np(got.params).items():
        np.testing.assert_array_equal(v, state.params[k].detach().numpy())
    adam = got.opt_state[1]
    for field in ("mu", "nu"):
        for k, v in _flat_np(getattr(adam, field)).items():
            np.testing.assert_array_equal(v, getattr(state.opt_state, field)[k].numpy())
    assert int(adam.count) == int(got.opt_state[2].count) == 17


def test_a_slot_that_is_no_train_state_raises(tmp_path):
    (tmp_path / "speech_latest.msgpack").write_bytes(
        serialization.msgpack_serialize({"W": np.ones(3, np.float32)}))
    with pytest.raises(ValueError, match="not a JAX TrainState"):
        tckpt.read_jax_checkpoint(str(tmp_path), "speech")
