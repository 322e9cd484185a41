"""The port's ``fit`` knobs held against the JAX package's ``fit``: the
device-resident corpus path (``device_data``) beside the host path,
``sync_every``, ``keep_best_state`` / ``best_state_loss``, ``stop_below``,
a caller-owned ``plateau_controller`` across chunks and resumes,
``async_checkpoints``; the speech corpus cache (``--cache-dir``) shared
by both packages; ``debug_nans``; and the train CLI's ``--trace-dir``,
``--debug-nans``, ``--async-checkpoints`` and ``--cache-dir``.

Tolerances, each with its reason:
  * the port's two data paths, sync_every 1 and 2, sync and async slots:
    bit for bit (the same rows, steps and draws; the same bytes written);
  * the port against JAX (f32, dropout and noise at 0): losses, best
    losses and grad norms 1e-4 relative (f32 sums in another order over a
    few epochs of updates); epochs run, best epochs, slot names, the
    plateau controller's scales and the warnings equal.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.data import formats as jformats
from mgr_tpu.data.batcher import Batcher as JBatcher
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import tracing
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import formats as tformats
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.data.batcher import Batcher as TBatcher
from mgr_tpu_torch.models import zoo
from mgr_tpu_torch.train import loop as tloop
from mgr_tpu_torch.train import optimizer as topt
from mgr_tpu_torch.train import step as tstep

torch.set_num_threads(1)

T, N = 24, 4
TOL_F32 = 1e-4
OFF = dict(input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0)


@pytest.fixture(autouse=True)
def jax_steps_compiled_once(monkeypatch):
    """The JAX fit builds and compiles its train and eval steps anew on
    every call; the tests here call it several times on one model, so the
    steps (pure functions of their arguments) are built once a model."""
    built = {}
    for name in ("make_train_step", "make_eval_step"):
        def once(model, mesh=None, _make=getattr(jloop, name), _name=name):
            key = (_name, id(model), mesh)
            if key not in built:
                built[key] = (model, _make(model, mesh=mesh))
            return built[key][1]

        monkeypatch.setattr(jloop, name, once)


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _fit_cfg(name="skeletal", **kw):
    over = dict(maxlen=T, batch_size=2, max_label_len=N, compute_dtype="float32", patience=2,
                encoder=cfglib.EncoderConfig(hidden=8, depth=2, **OFF),
                optimizer=cfglib.OptimizerConfig(learning_rate=0.05, decay=1e-5))
    over.update(kw)
    return cfglib.get_preset(name).replace(**over)


def _pair(cfg):
    """The JAX model and the port's model on the JAX fit's initial weights
    (it draws them from the config's seed; the port's fit starts from the
    model's)."""
    jmodel = jbuild(cfg)
    init = jax.tree.map(np.array, jmodel.init(jprng.root_key(cfg.seed)))
    return jmodel, bridge.load_params(zoo.build_model(_port(cfg), device="cpu"), init)


def _twin(tmodel):
    """A second port model with ``tmodel``'s weights (fit trains in place)."""
    twin = zoo.build_model(tmodel.config, device="cpu")
    twin.load_state_dict(tmodel.state_dict())
    return twin


def _corpus(cfg, n_files=8, seed=0, nan=False):
    """Seeded features and labels (the draws of test_torch_train's corpus),
    a second stream for the fusion families; 6 train and 2 val files."""
    rng = np.random.default_rng(seed)
    lab_len = rng.integers(1, N + 1, size=n_files).astype(np.int32)
    lab_len[0] = 0
    labels = np.full((n_files, N), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    feats = rng.standard_normal((n_files, T, cfg.num_feats)).astype(np.float32)
    in_len = rng.integers(2 * N + 1, T - 1, size=n_files).astype(np.int32)
    if nan:
        feats[:, 3, 0] = np.nan
    if cfg.second_stream_feats:
        feats = (feats, rng.standard_normal((n_files, T, cfg.second_stream_feats))
                 .astype(np.float32))
    ids = list(range(100, 100 + n_files))
    args = (feats, labels, lab_len, in_len, ids)
    split = dict(train_ids=ids[:6], val_ids=ids[6:])
    return JBatcher(*args, **split), TBatcher(*args, **split)


def _files(workdir):
    return sorted(f for f in os.listdir(workdir) if not f.endswith("metrics.jsonl"))


def _assert_same_params(a, b):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), "parameters differ"


def _close(got, want, key):
    np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want],
                               rtol=TOL_F32, err_msg=key)


# ------------------------------------------------------------------ data paths


def test_fit_on_both_data_paths_matches_jax_fit(tmp_path):
    """The device path (the default) and the host path give the same bits,
    and each the JAX fit's history, best epoch, early stop, slots and
    fitmeta."""
    cfg = _fit_cfg(reduce_lr_factor=0.5, reduce_lr_patience=1)
    jmodel, tmodel = _pair(cfg)
    jdata, tdata = _corpus(cfg)
    jres = jloop.fit(jmodel, jdata, workdir=str(tmp_path / "jax"), epochs=12)
    res = {}
    for on in (True, False):
        res[on] = tloop.fit(_twin(tmodel), tdata, workdir=str(tmp_path / str(on)), epochs=12,
                            device_data=on)
        assert res[on].epochs_run == jres.epochs_run < 12
        for key in ("train_loss", "val_loss", "grad_norm", "lr_scale"):
            _close(res[on].history, jres.history, key)
        best = int(np.argmin([h["val_loss"] for h in jres.history]))
        assert int(np.argmin([h["val_loss"] for h in res[on].history])) == best
        assert abs(res[on].best_val_loss - jres.best_val_loss) <= TOL_F32 * jres.best_val_loss
    _assert_same_params(res[True].state.params, res[False].state.params)
    assert [h["train_loss"] for h in res[True].history] == \
        [h["train_loss"] for h in res[False].history]
    metas = [json.load(open(tmp_path / d / "skeletal_fitmeta.json"))
             for d in ("True", "False", "jax")]
    assert metas[0] == metas[1]
    assert metas[0].keys() == metas[2].keys()
    assert metas[0]["plateau"] == pytest.approx(metas[2]["plateau"])
    assert _files(tmp_path / "True") == _files(tmp_path / "False")
    for slot in ("best", "latest"):
        _assert_same_params(tckpt.read_params(str(tmp_path / "True"), "skeletal", slot=slot),
                            tckpt.read_params(str(tmp_path / "False"), "skeletal", slot=slot))


@pytest.mark.parametrize("name", ["speech", "early_fusion"])
def test_device_path_gives_the_host_paths_bits_with_dropout_and_noise(name):
    """Noise and dropout on (speech's, and early fusion's two streams, both
    held on the device): the draws follow the step, not the data path."""
    cfg = _port(_fit_cfg(name, encoder=cfglib.EncoderConfig(hidden=8, depth=2),
                         patience=50, optimizer=cfglib.OptimizerConfig(learning_rate=1e-2)))
    _, tdata = _corpus(cfg, seed=3)
    model = zoo.build_model(cfg, device="cpu")
    res = {on: tloop.fit(_twin(model), tdata, epochs=2, device_data=on) for on in (True, False)}
    _assert_same_params(res[True].state.params, res[False].state.params)
    assert res[True].history[-1]["val_loss"] == res[False].history[-1]["val_loss"]
    if name == "early_fusion":
        assert set(tdata.device_arrays()) == {"inputs", "inputs2", "labels", "input_length",
                                              "label_length"}


def test_device_data_refuses_a_lazy_corpus_and_a_mesh(tmp_path):
    cfg = _port(_fit_cfg())
    _, tdata = _corpus(cfg)
    lazy = tdatasets.LazyVideoBatcher(str(tmp_path), [], cfg, tdata.labels, tdata.label_lengths,
                                      tdata.input_lengths, tdata.file_ids, tdata.train_ids,
                                      tdata.val_ids)
    model = zoo.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="holds no features"):
        tloop.fit(model, lazy, device_data=True)


def test_build_model_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port(_fit_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.build_model(cfg)
    assert next(zoo.build_model(cfg, device="cpu").parameters()).device.type == "cpu"


# ------------------------------------------------------------------ the knobs


def test_sync_every_keeps_the_trajectory_and_warns_as_jax(tmp_path, caplog):
    """sync_every=2: the parameters of sync_every=1, bit for bit, one
    record a window; the JAX fit's windows and its two warnings."""
    cfg = _fit_cfg(patience=50)
    jmodel, tmodel = _pair(cfg)
    jdata, tdata = _corpus(cfg, seed=1)
    one = tloop.fit(_twin(tmodel), tdata, epochs=4, monitor="train")
    two = tloop.fit(_twin(tmodel), tdata, epochs=4, monitor="train", sync_every=2)
    _assert_same_params(one.state.params, two.state.params)
    assert [h["epochs_in_record"] for h in two.history] == [2, 2]
    assert [h["epoch"] for h in two.history] == [1, 3]
    assert two.best_val_loss == one.best_val_loss and two.epochs_run == 4
    jtwo = jloop.fit(jmodel, jdata, epochs=4, monitor="train", sync_every=2)
    for key in ("train_loss", "val_loss", "grad_norm"):
        _close(two.history, jtwo.history, key)

    warned = {}
    for tag, fit, model, data in (("jax", jloop.fit, jmodel, jdata),
                                  ("torch", tloop.fit, _twin(tmodel), tdata)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            fit(model, data, workdir=str(tmp_path / tag), epochs=2, sync_every=2)
        warned[tag] = sorted(r.getMessage() for r in caplog.records
                             if r.getMessage().startswith("fit(sync_every"))
    assert len(warned["torch"]) == 2 and warned["torch"] == warned["jax"]


def test_keep_best_state_and_best_state_loss_match_jax(tmp_path):
    cfg = _fit_cfg(patience=50)
    jmodel, tmodel = _pair(cfg)
    jdata, tdata = _corpus(cfg, seed=2)
    wd = str(tmp_path)
    res = tloop.fit(_twin(tmodel), tdata, workdir=wd, epochs=5, monitor="train",
                    keep_best_state=True, checkpoint_every=2)
    jres = jloop.fit(jmodel, jdata, epochs=5, monitor="train", keep_best_state=True,
                     checkpoint_every=2)
    assert res.best_val_loss == pytest.approx(jres.best_val_loss, rel=TOL_F32)
    assert res.best_state_loss == res.best_val_loss  # sync_every=1: the improving epoch
    _assert_same_params(tckpt.read_params(wd, "skeletal", slot="best"),
                        {k: v.cpu() for k, v in res.best_state.params.items()})
    assert res.best_state.step == int(jres.best_state.step)
    assert all(not v.data_ptr() == p.data_ptr() for v, p in
               zip(res.best_state.params.values(), res.state.params.values()))

    four = tloop.fit(_twin(tmodel), tdata, epochs=8, monitor="train", keep_best_state=True,
                     sync_every=4)
    jfour = jloop.fit(jmodel, jdata, epochs=8, monitor="train", keep_best_state=True,
                      sync_every=4)
    assert four.best_state_loss >= four.best_val_loss
    assert four.best_state_loss == pytest.approx(jfour.best_state_loss, rel=TOL_F32)
    assert tloop.fit(_twin(tmodel), tdata, epochs=1).best_state is None


def test_stop_below_matches_jax():
    cfg = _fit_cfg(patience=50)
    jmodel, tmodel = _pair(cfg)
    jdata, tdata = _corpus(cfg, seed=4)
    got = tloop.fit(_twin(tmodel), tdata, epochs=3, monitor="train", stop_below=1e9)
    want = jloop.fit(jmodel, jdata, epochs=3, monitor="train", stop_below=1e9)
    assert got.epochs_run == want.epochs_run == 1  # the first finite loss is below
    assert got.history[0]["train_loss"] == pytest.approx(want.history[0]["train_loss"],
                                                         rel=TOL_F32)
    never = tloop.fit(_twin(tmodel), tdata, epochs=3, monitor="train", stop_below=0.0)
    assert never.epochs_run == 3


def test_plateau_controller_across_chunks_and_resumes_matches_jax(tmp_path):
    """A caller's controller keeps its annealed scale across fit calls; a
    resume restores the fitmeta's state into a pristine controller (the
    one fit builds, or a fresh caller's) and leaves an annealed one as it
    is. The scales of each run equal the JAX fit's."""
    cfg = _fit_cfg(patience=1000, optimizer=cfglib.OptimizerConfig(learning_rate=1e-12),
                   reduce_lr_factor=0.5, reduce_lr_patience=1, reduce_lr_min=1e-18)
    jmodel, tmodel = _pair(cfg)
    jdata, tdata = _corpus(cfg, seed=5)
    annealed = {"scale": 0.015625, "best": 1.0, "wait": 0, "cooldown_counter": 0}
    scales = {}
    for tag, fit, model, data, ctl_of in (
            ("jax", jloop.fit, jmodel, jdata, jopt.plateau_from_config),
            ("torch", tloop.fit, tmodel, tdata, lambda c: topt.plateau_from_config(_port(c)))):
        wd = str(tmp_path / tag)
        ctl = ctl_of(cfg)
        runs = [fit(model, data, workdir=wd, epochs=3, monitor="train", plateau_controller=ctl)]
        if tag == "torch":  # the next chunk goes on from the annealed scale
            end = runs[0].history[-1]["lr_scale"]
            chunk = fit(model, data, epochs=3, monitor="train", plateau_controller=ctl)
            assert end < 1.0 and all(h["lr_scale"] <= end for h in chunk.history)
        fresh = ctl_of(cfg)
        assert fresh.is_pristine()
        runs.append(fit(model, data, workdir=wd, epochs=5, monitor="train", resume=True,
                        plateau_controller=fresh))
        runs.append(fit(model, data, workdir=wd, epochs=7, monitor="train", resume=True))
        newer = ctl_of(cfg)
        newer.load_state_dict(annealed)
        assert not newer.is_pristine()
        runs.append(fit(model, data, workdir=wd, epochs=9, monitor="train", resume=True,
                        plateau_controller=newer))
        scales[tag] = [[h["lr_scale"] for h in r.history] for r in runs]
        end = scales[tag][0][-1]
        assert scales[tag][1][0] <= end and scales[tag][2][0] <= end
        assert scales[tag][3][0] == annealed["scale"]  # not overwritten by the disk's
    assert scales["torch"] == scales["jax"]


def test_async_checkpoints_write_the_bytes_of_sync_ones(tmp_path):
    cfg = _port(_fit_cfg(patience=50, reduce_lr_factor=0.5, reduce_lr_patience=1))
    _, tdata = _corpus(cfg, seed=6)
    model = zoo.build_model(cfg, device="cpu")
    for tag, on in (("sync", False), ("async", True)):
        tloop.fit(_twin(model), tdata, workdir=str(tmp_path / tag), epochs=3,
                  async_checkpoints=on, checkpoint_every=2)
    files = _files(tmp_path / "sync")
    assert files == _files(tmp_path / "async") and "skeletal_best.state.pt" in files
    for f in files:
        assert (tmp_path / "sync" / f).read_bytes() == (tmp_path / "async" / f).read_bytes(), f


def test_async_checkpointer_raises_a_failed_write_and_writes_no_more(tmp_path, monkeypatch):
    cfg = _port(_fit_cfg())
    state = tstep.create_train_state(zoo.build_model(cfg, device="cpu"))
    writer = tckpt.AsyncCheckpointer(str(tmp_path), "skeletal")
    real = torch.save

    def refuse(obj, path):
        if "latest" in str(path):
            raise OSError("disk full")
        return real(obj, path)

    monkeypatch.setattr(torch, "save", refuse)
    writer.save(state, slot="latest", meta={"num_train_batches": 3})
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    with pytest.raises(OSError, match="disk full"):
        writer.save(state, slot="best")
    assert not os.path.exists(tmp_path / "skeletal_fitmeta.json")


# ------------------------------------------------------------------ numerics


@pytest.fixture
def nan_checks():
    tracing.debug_nans(True)
    try:
        yield
    finally:
        tracing.debug_nans(False)


def test_debug_nans_raises_on_a_nan_input(nan_checks):
    assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    cfg = _port(_fit_cfg())
    _, tdata = _corpus(cfg, nan=True)
    model = zoo.build_model(cfg, device="cpu")
    for on in (True, False):
        with pytest.raises(FloatingPointError, match="loss is not finite"):
            tloop.fit(model, tdata, epochs=1, device_data=on)
    with pytest.raises(FloatingPointError, match="loss is not finite"):
        tstep.make_eval_step(model)(next(tdata.epoch(2, train=False))[1])


def test_trace_writes_the_named_ranges_and_nothing_without_a_dir(tmp_path):
    with tracing.trace(str(tmp_path / "t")):
        with tracing.annotate("fitknobs-range"):
            torch.ones(3).add_(1)
    (trace,) = [f for f in os.listdir(tmp_path / "t") if f.endswith(".pt.trace.json")]
    events = json.load(open(tmp_path / "t" / trace))["traceEvents"]
    assert any(e.get("name") == "fitknobs-range" for e in events)
    with tracing.trace(None), tracing.trace(""):
        pass
    assert os.listdir(tmp_path) == ["t"]


def test_without_debug_nans_a_nan_input_trains_on():
    cfg = _port(_fit_cfg())
    _, tdata = _corpus(cfg, nan=True)
    res = tloop.fit(zoo.build_model(cfg, device="cpu"), tdata, epochs=1)
    assert np.isnan(res.history[0]["train_loss"])
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------------------ corpus cache


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fitknobs_audio"))
    data_dir, labels, _ = synthetic.make_audio_dataset(root, n_files=10, frames_per_label=30,
                                                       seed=3)
    return data_dir, labels


def _speech_cfg():
    return _fit_cfg("speech", max_label_len=12, patience=50)


def test_cache_dir_is_read_by_the_other_package(audio, tmp_path, monkeypatch):
    """A cache JAX writes, the port reads without parsing a CSV, and the
    reverse; both give the arrays a build from the CSVs gives."""
    data_dir, labels = audio
    cfg = _speech_cfg()
    fresh = tdatasets.build_audio_dataset(data_dir, labels, _port(cfg))
    jdatasets.build_audio_dataset(data_dir, labels, cfg, cache_dir=str(tmp_path / "j"))
    tdatasets.build_audio_dataset(data_dir, labels, _port(cfg), cache_dir=str(tmp_path / "t"))
    assert os.listdir(tmp_path / "j") == os.listdir(tmp_path / "t")

    def no_csv(path):
        raise AssertionError(f"parsed {path} despite the cache")

    monkeypatch.setattr(tformats, "load_audio_file_csv", no_csv)
    monkeypatch.setattr(jformats, "load_audio_file_csv", no_csv)
    got = tdatasets.build_audio_dataset(data_dir, labels, _port(cfg), cache_dir=str(tmp_path / "j"))
    back = jdatasets.build_audio_dataset(data_dir, labels, cfg, cache_dir=str(tmp_path / "t"))
    for b in (got, back):
        for attr in ("features", "labels", "label_lengths", "input_lengths"):
            np.testing.assert_array_equal(np.asarray(getattr(b, attr)), getattr(fresh, attr))
        assert (b.file_ids, b.train_ids, b.val_ids) == \
            (fresh.file_ids, fresh.train_ids, fresh.val_ids)


def test_train_cli_flags_match_jax_cli(audio, tmp_path, capsys, monkeypatch):
    """`train speech` with --async-checkpoints and --cache-dir through both
    CLIs on the same weights: the same result and cache file; the port's
    --trace-dir writes a trace, and --debug-nans is off again after."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli.main import main as tmain

    cfg = _speech_cfg()
    monkeypatch.setitem(cfglib.PRESETS, "speech", lambda: cfg)
    monkeypatch.setitem(tconfig.PRESETS, "speech", lambda: _port(cfg))
    init = jax.tree.map(np.array, jbuild(cfg).init(jprng.root_key(cfg.seed)))
    real_build = zoo.build_model
    monkeypatch.setattr(zoo, "build_model", lambda c, **kw: bridge.load_params(
        real_build(c, **kw), init))
    data_dir, labels = audio
    outs = {}
    for tag, main, extra in (
            ("jax", jmain, []),
            ("torch", tmain, ["--device", "cpu", "--trace-dir", str(tmp_path / "trace"),
                              "--debug-nans"])):
        assert main(["train", "speech", "--data-dir", data_dir, "--labels", labels,
                     "--workdir", str(tmp_path / tag), "--epochs", "2", "--async-checkpoints",
                     "--cache-dir", str(tmp_path / f"cache_{tag}"), *extra]) == 0
        outs[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["torch"]["epochs_run"] == outs["jax"]["epochs_run"] == 2
    assert outs["torch"]["best_val_loss"] == pytest.approx(outs["jax"]["best_val_loss"],
                                                           rel=TOL_F32)
    assert os.listdir(tmp_path / "cache_torch") == os.listdir(tmp_path / "cache_jax")
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "trace"))
    assert not torch.is_anomaly_enabled()
    assert tckpt.has_checkpoint(str(tmp_path / "torch"), "speech", "best")
