"""The port's curriculum (``mgr_tpu_torch.train.curriculum``) and the late
fusion family's commands held against the JAX package's: the graft of
uni-modal encoders into a late-fusion tree, the fusion model built from a
workdir's best slots, `train`/`decode`/`evaluate late_fusion` through
both CLIs (the donors carried across by the bridge), and `curriculum` end
to end on the CPU.

Tolerances: the graft and the bridge bit for bit; f32 logits 1e-4
absolute; best losses 1e-4 relative (f32 sums in another order over a few
epochs); config, MLF and metrics equal.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from mgr_tpu.core import checkpoint as jckpt
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train import curriculum as jcurriculum
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.train import curriculum as tcurriculum

torch.set_num_threads(1)

T, N = 24, 4
TOL_LOGITS = 1e-4
TOL_LOSS_REL = 1e-4


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _configs():
    """speech, skeletal and late fusion at test size, f32, with noise and
    dropout off (the two packages' draws differ), batch 2."""
    off = dict(input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0)
    common = dict(maxlen=T, batch_size=2, compute_dtype="float32", patience=50,
                  optimizer=cfglib.OptimizerConfig(learning_rate=0.05, decay=1e-5))
    return {
        "speech": cfglib.get_preset("speech").replace(
            max_label_len=12, encoder=cfglib.EncoderConfig(hidden=8, depth=2, **off), **common),
        "skeletal": cfglib.get_preset("skeletal").replace(
            max_label_len=N, encoder=cfglib.EncoderConfig(hidden=6, depth=2, **off), **common),
        "late_fusion": cfglib.get_preset("late_fusion").replace(
            max_label_len=N, fusion_hidden=4, fusion_dropout=0.0, fusion_output_dropout=0.0,
            encoder=cfglib.EncoderConfig(hidden=8, depth=2, **off), **common),
    }


def _sources(cfgs):
    return {k: cfgs[k] for k in ("speech", "skeletal")}


def _weights(cfg, sources=None, seed=0):
    """Seeded weights of ``cfg``'s model as a JAX tree of numpy arrays (the
    port's init through the bridge: no XLA compile)."""
    tsources = None if sources is None else {k: _port(v) for k, v in sources.items()}
    return bridge.params_to_numpy(tbuild(_port(cfg), tsources, seed=seed, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_inits():
    """The JAX package's initial weights of the three test-size configs
    (what its fit starts from), computed once."""
    cfgs = _configs()
    return {name: jax.tree.map(np.array, jax.jit(jbuild(
        cfg, _sources(cfgs) if name == "late_fusion" else None).init)(
            jprng.root_key(cfg.seed))) for name, cfg in cfgs.items()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Skeletal CSV + labels and per-file audio CSVs (5x the frame rate)
    + their labels, for the same ten files."""
    root = str(tmp_path_factory.mktemp("torch_curriculum"))
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=10, frames_per_label=6, seed=7)
    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        root, labels=labels, frames_per_label=30, seed=8)
    return dict(sk_csv=sk_csv, labels=sk_labels, audio_dir=audio_dir,
                audio_labels=audio_labels)


@pytest.fixture
def small_presets(monkeypatch):
    """Both packages' presets at test size, and the port's models built
    on the JAX package's initial weights (its fit starts from the model's
    weights; the JAX fit draws them from the seed)."""
    from mgr_tpu_torch.models import zoo

    cfgs = _configs()
    for name, cfg in cfgs.items():
        monkeypatch.setitem(cfglib.PRESETS, name, lambda c=cfg: c)
        monkeypatch.setitem(tconfig.PRESETS, name, lambda c=cfg: _port(c))
    inits = _jax_inits()
    real_build = zoo.build_model
    monkeypatch.setattr(zoo, "build_model", lambda c, *a, **kw: bridge.load_params(
        real_build(c, *a, **kw), inits[c.name]))
    return cfgs, real_build


def _run(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _donors(cfgs, jdir, tdir):
    """Speech and skeletal best slots of the same weights in a JAX and a
    port workdir; returns the JAX params of each."""
    out = {}
    for name, seed in (("speech", 11), ("skeletal", 12)):
        params = _weights(cfgs[name], seed=seed)
        state = jstep.TrainState(np.zeros((), np.int32), params,
                                 jopt.keras_adam(cfgs[name].optimizer).init(params))
        jckpt.save_checkpoint(jdir, name, state, slot="best")
        tmodel = bridge.load_params(tbuild(_port(cfgs[name]), device="cpu"), params)
        tckpt.save_params(tdir, name, tmodel, slot="best")
        out[name] = params
    return out


# ------------------------------------------------------------------ graft


def test_graft_matches_jax_bit_for_bit():
    cfgs = _configs()
    fusion = _weights(cfgs["late_fusion"], _sources(cfgs), seed=1)
    speech = _weights(cfgs["speech"], seed=2)
    skeletal = _weights(cfgs["skeletal"], seed=3)
    want = bridge.flatten(jcurriculum.graft_pretrained_encoders(fusion, speech, skeletal))
    got = tcurriculum.graft_pretrained_encoders(
        *(bridge.params_from_numpy(t) for t in (fusion, speech, skeletal)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    wide = cfgs["speech"].replace(encoder=cfglib.EncoderConfig(hidden=10))
    with pytest.raises(ValueError, match="donor shape"):
        tcurriculum.graft_pretrained_encoders(
            *(bridge.params_from_numpy(t) for t in (fusion, _weights(wide), skeletal)))


def test_fusion_with_pretrained_gives_the_jax_logits(tmp_path):
    """The port builds late fusion from a workdir's best slots (JAX donors
    carried across by the bridge): the JAX graft of those donors into the
    same fusion init, bit for bit, and its logits."""
    cfgs = _configs()
    sources = _sources(cfgs)
    donors = _donors(cfgs, str(tmp_path / "jax"), str(tmp_path / "torch"))
    tsources = {k: _port(v) for k, v in sources.items()}
    tmodel = tcurriculum.build_fusion_with_pretrained(
        str(tmp_path / "torch"), _port(cfgs["late_fusion"]), tsources, device="cpu")
    jparams = jcurriculum.graft_pretrained_encoders(
        _weights(cfgs["late_fusion"], sources, seed=cfgs["late_fusion"].seed),
        donors["speech"], donors["skeletal"])
    state = tmodel.state_dict()
    for k, v in bridge.flatten(jparams).items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    jmodel = jbuild(cfgs["late_fusion"], sources)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, T, 39)).astype(np.float32),
         rng.standard_normal((3, T, 20)).astype(np.float32))
    want = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    with torch.no_grad():
        got = tmodel(tuple(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_LOGITS, rtol=0)


# ------------------------------------------------------------------ CLI


def test_late_fusion_cli_matches_jax_cli(corpus, small_presets, tmp_path, capsys):
    """`train late_fusion` grafts each workdir's donors and trains through
    both CLIs to the same result; the JAX-trained weights, bridged into a
    port workdir beside the donors, decode to the JAX CLI's MLF and
    evaluate to its metrics."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli.main import main as tmain

    cfgs, real_build = small_presets
    dirs = {tag: str(tmp_path / tag) for tag in ("jax", "torch")}
    _donors(cfgs, dirs["jax"], dirs["torch"])
    data = ["--audio-dir", corpus["audio_dir"], "--skeletal-csv", corpus["sk_csv"],
            "--labels", corpus["labels"]]
    outs = {}
    for tag, main, dev in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        outs[tag] = _run(capsys, main, ["train", "late_fusion", "--workdir", dirs[tag],
                                        "--epochs", "3", *dev, *data])
    assert outs["torch"]["epochs_run"] == outs["jax"]["epochs_run"] == 3
    assert outs["torch"]["best_val_loss"] == pytest.approx(outs["jax"]["best_val_loss"],
                                                           rel=TOL_LOSS_REL)
    assert json.load(open(f"{dirs['torch']}/late_fusion_config.json")) == \
        json.load(open(f"{dirs['jax']}/late_fusion_config.json"))
    # The frozen encoders left the port's training bit-unchanged.
    best = tckpt.read_params(dirs["torch"], "late_fusion")
    donor = tckpt.read_params(dirs["torch"], "speech")
    assert all(torch.equal(best[f"speech.{k[len('encoder.'):]}"], v)
               for k, v in donor.items() if k.startswith("encoder."))

    jmodel, _ = jcurriculum.build_fusion_with_pretrained(dirs["jax"], cfgs["late_fusion"])
    trained = jax.tree.map(np.array, jloop.load_params_for_eval(jmodel, dirs["jax"]))
    same = str(tmp_path / "same")
    _donors(cfgs, str(tmp_path / "unused"), same)
    tckpt.save_config(same, "late_fusion", _port(cfgs["late_fusion"]))
    tckpt.save_params(same, "late_fusion", bridge.load_params(
        real_build(_port(cfgs["late_fusion"]), device="cpu"), trained))
    got = {}
    for tag, main, wd, dev in (("jax", jmain, dirs["jax"], []),
                               ("torch", tmain, same, ["--device", "cpu"])):
        mlf = str(tmp_path / f"{tag}.mlf")
        dec = _run(capsys, main, ["decode", "late_fusion", "--workdir", wd, "--out", mlf,
                                  *dev, *data])
        ev = _run(capsys, main, ["evaluate", "late_fusion", "--workdir", wd, "--dataset",
                                 "val", *dev, *data])
        got[tag] = (dec["decoded"], open(mlf).read(), ev)
    assert got["torch"] == got["jax"] and got["torch"][0] == 10
    assert "sil" in got["torch"][1]

    # --from-scratch trains without donors.
    scratch = _run(capsys, tmain, ["train", "late_fusion", "--workdir", str(tmp_path / "s"),
                                   "--epochs", "1", "--from-scratch", "--device", "cpu", *data])
    assert scratch["epochs_run"] == 1


def test_curriculum_cli_end_to_end(corpus, small_presets, tmp_path, capsys):
    """`curriculum --device cpu`: three stages in one workdir, the fusion
    stage from the other two's best slots (its frozen encoders end equal
    to them), the speech and skeletal stages as the JAX CLI trains them,
    and the result decodes."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli.main import main as tmain

    argv = ["curriculum", "--audio-dir", corpus["audio_dir"], "--audio-labels",
            corpus["audio_labels"], "--skeletal-csv", corpus["sk_csv"], "--labels",
            corpus["labels"], "--epochs", "2"]
    wd = str(tmp_path / "torch")
    got = _run(capsys, tmain, [*argv, "--workdir", wd, "--device", "cpu"])
    want = _run(capsys, jmain, [*argv, "--workdir", str(tmp_path / "jax")])
    assert set(got) == set(want) == {"speech", "skeletal", "late_fusion"}
    for stage in got:
        assert got[stage]["epochs"] == want[stage]["epochs"] == 2
        assert got[stage]["best_val_loss"] == pytest.approx(want[stage]["best_val_loss"],
                                                            rel=TOL_LOSS_REL), stage
    files = set(os.listdir(wd))
    assert {f"{s}_best.params.pt" for s in got} <= files
    fused = tckpt.read_params(wd, "late_fusion")
    for name in ("speech", "skeletal"):
        donor = tckpt.read_params(wd, name)
        for k, v in donor.items():
            if k.startswith("encoder."):
                assert torch.equal(fused[f"{name}.{k[len('encoder.'):]}"], v)
    dec = _run(capsys, tmain, ["decode", "late_fusion", "--workdir", wd, "--out",
                               str(tmp_path / "c.mlf"), "--audio-dir", corpus["audio_dir"],
                               "--skeletal-csv", corpus["sk_csv"], "--labels",
                               corpus["labels"], "--device", "cpu"])
    assert dec["decoded"] == 10
