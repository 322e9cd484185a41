"""The port's training path (mgr_tpu_torch.train) held against the JAX
package's: Keras-parity Adam, the train step, fit and the train CLI, on
the same weights, batches and random masks.

JAX's key streams cannot be reproduced in torch, so the tests that
compare draws substitute the port's ``prng.bernoulli`` / ``prng.normal``
with ``jax.random`` draws on the same fold path (the ``jax_streams``
fixture of ``tests/torch_jax_draws.py``): a port key is the path itself,
replayed there through ``mgr_tpu.core.prng``. The production path has no
masks argument.

Tolerances, each with its reason:
  * Adam state, updates and parameters: 1e-6 relative, 1e-8 absolute
    (f32 elementwise chains; the two frameworks' pow and sqrt may differ
    in the last bit, and one f32 ulp at the parameters' scale of 0.1 is
    7e-9).
  * bf16 train step vs ``make_train_step`` with the Pallas kernels in
    interpret mode: loss 1e-3 relative, gradients 1e-2 relative
    Frobenius per leaf, grad norm 1e-2 relative (bf16 operands rounded at
    the same places, f32 sums in another order; one bf16 ulp is 4e-3).
    Updated parameters (here and in f32): an Adam step is
    ``-lr * g / (|g| + eps)`` at step one, so where a tiny gradient's sign
    differs the update flips (2 * lr); at most 2% of the entries may, the
    rest agree to 1e-6.
  * f32 train step and fit vs the XLA path (dropout and noise at 0):
    losses 1e-4 relative per epoch (f32 sums in another order, over a few
    epochs of updates).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.data.batcher import Batcher as JBatcher
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.models import layers as jlayers
from mgr_tpu.ops import dispatch as jdispatch
from mgr_tpu.ops import lstm as jlstm
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import checkpoint as tckpt
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.data.batcher import Batcher as TBatcher
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.models import layers as tlayers
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.train import loop as tloop
from mgr_tpu_torch.train import optimizer as topt
from mgr_tpu_torch.train import step as tstep
from torch_jax_draws import jax_key, jax_streams  # noqa: F401

torch.set_num_threads(1)

T, B, N = 24, 3, 4
TOL_ADAM = 1e-6
TOL_LOSS_BF16 = 1e-3
TOL_GRAD_BF16 = 1e-2
TOL_F32 = 1e-4


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def _pair(cfg, seed=0):
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jprng.root_key(seed))
    tmodel = bridge.load_params(tbuild(_port(cfg), device="cpu"), jax.tree.map(np.array, jparams))
    return jmodel, jparams, tmodel


def _batch(cfg, seed=1, n=B):
    rng = np.random.default_rng(seed)
    lab_len = rng.integers(1, N + 1, size=n).astype(np.int32)
    lab_len[0] = 0
    labels = np.full((n, N), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    return {
        "inputs": rng.standard_normal((n, T, cfg.num_feats)).astype(np.float32),
        "labels": labels,
        "input_length": rng.integers(2 * N + 1, T - 1, size=n).astype(np.int32),
        "label_length": lab_len,
    }


def _params_close(got, want, bound):
    """Adam's early updates are -lr * g / (|g| + eps): where a tiny
    gradient's sign differs between the two frameworks the update flips.
    Every entry within ``bound`` (the flipped updates' size), at most 2%
    of them more than 1e-6 apart."""
    diff = np.abs(got - want)
    assert diff.max() <= bound + 1e-6
    assert (diff > 1e-6).mean() <= 0.02


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(tree).items()}


def _speech_cfg(**kw):
    """The speech preset at test size: full structure (noise 0.5, input
    dropout 0.4/0.5, head dropout 0.5, residual, 44 classes, trim 2)."""
    return cfglib.get_preset("speech").replace(
        maxlen=T, batch_size=B, max_label_len=N,
        encoder=cfglib.EncoderConfig(hidden=8, depth=2), **kw)


# ---------------------------------------------------------------- optimizer


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "encoder": {"blstm_0": {"W": rng.standard_normal((2, 5, 4, 3)).astype(np.float32),
                                "U": rng.standard_normal((2, 3, 4, 3)).astype(np.float32)}},
        "head": {"W": rng.standard_normal((6, 4)).astype(np.float32),
                 "b": np.zeros(4, np.float32)},
    }


def test_keras_adam_matches_optax_chain():
    """N steps with clipping, decay 1e-5, skip_nonfinite on a NaN grad
    (dropped, moments kept), then maxnorm(3) on the LSTM input kernel."""
    ocfg = cfglib.OptimizerConfig(learning_rate=1e-2, clipvalue=0.5, decay=1e-5,
                                  skip_nonfinite=2)
    params = _opt_tree(0)
    jtx = jopt.keras_adam(ocfg)
    jstate = jtx.init(jax.tree.map(jnp.asarray, params))
    ttx = topt.keras_adam(_port(cfglib.PipelineConfig(optimizer=ocfg)).optimizer)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    tstate = ttx.init(tparams)
    jp, tp = jax.tree.map(jnp.asarray, params), dict(tparams)
    for i in range(6):
        grads = jax.tree.map(
            lambda x: (np.random.default_rng(10 + i).standard_normal(x.shape) * 2).astype(np.float32),
            params)
        if i == 2:
            grads["head"]["W"][0, 0] = np.nan
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = jopt.apply_maxnorm(optax.apply_updates(jp, ju), ocfg.maxnorm)
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in _flat(grads).items()}, tstate)
        tp = topt.apply_maxnorm({k: tp[k] + tu[k] for k in tp}, ocfg.maxnorm)
        for k, want in _flat(ju).items():
            np.testing.assert_allclose(tu[k].numpy(), want, rtol=TOL_ADAM, atol=1e-8)
            if i == 2:
                assert not want.any()  # the NaN step is dropped
        for k, want in _flat(jp).items():
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=TOL_ADAM, atol=1e-8)
    inner = jstate.inner_state
    assert int(tstate.count) == int(inner[1].count) == 5
    assert int(tstate.schedule_count) == int(inner[2].count) == 5
    assert int(tstate.total_notfinite) == int(jstate.total_notfinite) == 1
    for k, want in _flat(inner[1].mu).items():
        np.testing.assert_allclose(tstate.mu[k].numpy(), want, rtol=TOL_ADAM, atol=1e-8)
    w = tp["encoder.blstm_0.W"]
    assert float(torch.sqrt((w * w).sum(dim=1)).max()) <= 3.0 + 1e-5


def test_nonfinite_updates_apply_after_too_many_in_a_row():
    ocfg = tconfig.OptimizerConfig(skip_nonfinite=1)
    p = {"head.W": torch.zeros(3)}
    tx = topt.keras_adam(ocfg)
    st = tx.init(p)
    bad = {"head.W": torch.tensor([float("nan"), 1.0, 1.0])}
    u1, st = tx.update(bad, st)
    u2, st = tx.update(bad, st)  # second in a row > skip_nonfinite=1: applied
    assert not u1["head.W"].any() and torch.isnan(u2["head.W"][0])
    assert int(st.count) == 1 and int(st.notfinite_count) == 2


def test_maxnorm_only_on_lstm_input_kernels():
    big = torch.full((2, 4, 4, 3), 10.0)
    out = topt.apply_maxnorm({"encoder.blstm_0.W": big, "encoder.blstm_0.U": big,
                              "head.W": big}, 3.0)
    assert torch.equal(out["encoder.blstm_0.U"], big) and torch.equal(out["head.W"], big)
    want = jopt.apply_maxnorm({"encoder": {"blstm_0": {"W": jnp.asarray(big.numpy())}}}, 3.0)
    np.testing.assert_allclose(out["encoder.blstm_0.W"].numpy(),
                               np.asarray(want["encoder"]["blstm_0"]["W"]), rtol=1e-6)


def test_plateau_controller_matches_jax():
    kw = dict(factor=0.5, patience=2, min_lr=1e-5, base_lr=1e-4, min_delta=1e-4, cooldown=1)
    j, t = jopt.ReduceLROnPlateau(**kw), topt.ReduceLROnPlateau(**kw)
    for v in [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]:
        assert t.update(v) == j.update(v)
        assert t.state_dict() == j.state_dict()


# ------------------------------------------------------------ the train step


def test_speech_train_step_bf16_matches_jax(jax_streams, monkeypatch):
    """One whole speech-shaped train step in bf16 against
    mgr_tpu.train.step.make_train_step with the Pallas kernels (interpret
    mode), the JAX masks and noise substituted."""
    cfg = _speech_cfg()
    jmodel, jparams, tmodel = _pair(cfg, seed=3)
    batch = _batch(cfg, seed=4)
    key = prng.fold_in(prng.fold_name(prng.root_key(cfg.seed), "dropout"), 7)
    monkeypatch.setattr(jdispatch, "MODE", "pallas")

    jgrads = jax.grad(lambda p: jstep._loss_from_batch(
        jmodel, p, batch, train=True, rng=jax_key(key)))(jparams)
    jstate = jstep.create_train_state(jmodel, jprng.root_key(3))
    jstate = jstate._replace(params=jparams)
    jnew, jm = jstep.make_train_step(jmodel)(jstate, batch, jax_key(key), 1.0)

    tstate = tstep.create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    loss, tgrads = tstep._loss_and_grads(
        tmodel, tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()}, key)
    tgrads = {k: g.clone() for k, g in tgrads.items()}
    n_draws = len(jax_streams)
    tstate, tm = tstep.make_train_step(tmodel)(tstate, batch, key, 1.0)
    # Noise, two directions of two layers, the head: the same six draws
    # in both calls.
    assert n_draws == 6 and jax_streams[:6] == jax_streams[6:]
    assert ("normal", key.path + ("noise",)) in jax_streams
    assert ("bernoulli", key.path + ("drop_1", 1)) in jax_streams
    assert ("bernoulli", key.path + ("head_drop",)) in jax_streams

    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_LOSS_BF16 * abs(float(jm["loss"]))
    assert abs(float(loss) - float(jm["loss"])) <= TOL_LOSS_BF16 * abs(float(jm["loss"]))
    for k, want in _flat(jgrads).items():
        rel = np.linalg.norm(tgrads[k].numpy() - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= TOL_GRAD_BF16, (k, rel)
    gn = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= TOL_GRAD_BF16 * gn
    lr = cfg.optimizer.learning_rate
    for k, want in _flat(jnew.params).items():
        _params_close(tstate.params[k].detach().numpy(), want, 2 * lr)
        assert not torch.equal(tstate.params[k].detach(), before[k])
    assert tstate.step == 1 and int(jnew.step) == 1


def test_train_step_f32_with_accumulation_matches_jax():
    """accum_steps=3 microbatches in f32 (XLA path, no dropout): the
    summed-then-scaled loss and gradients, then two Adam steps."""
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                               output_dropout=0.0)
    cfg = cfglib.get_preset("skeletal").replace(
        maxlen=T, batch_size=6, max_label_len=N, encoder=enc, compute_dtype="float32",
        optimizer=cfglib.OptimizerConfig(accum_steps=3, learning_rate=1e-2, decay=1e-5))
    jmodel, jparams, tmodel = _pair(cfg, seed=5)
    jstate = jstep.create_train_state(jmodel, jprng.root_key(5))._replace(params=jparams)
    jfn, tfn = jstep.make_train_step(jmodel), tstep.make_train_step(tmodel)
    tstate = tstep.create_train_state(tmodel)
    for i in range(2):
        batch = _batch(cfg, seed=6 + i, n=6)
        jstate, jm = jfn(jstate, batch, jax.random.key(0), 0.5)
        tstate, tm = tfn(tstate, batch, None, 0.5)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_F32 * abs(float(jm["loss"]))
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= TOL_F32 * gn
    for k, want in _flat(jstate.params).items():  # two steps at lr 1e-2, scale 0.5
        _params_close(tstate.params[k].detach().numpy(), want, 2 * 2 * 1e-2 * 0.5)


def test_layer_grads_f32_match_xla_with_dropout(jax_streams):
    """A train-mode layer in f32 (the plain adjoint, the projection's
    explicit backward, per-gate dropout) against jax.grad of the XLA path
    on the same masks."""
    p = {k: np.array(v) for k, v in jlstm.init_bilstm_params(jax.random.key(1), 5, 8).items()}
    x = np.random.default_rng(2).standard_normal((T, B, 5)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((T, B, 16)).astype(np.float32)
    key = prng.fold_name(prng.root_key(4), "drop_0")
    for per_gate in (False, True):
        kw = dict(dropout=0.4, per_gate=per_gate, train=True)
        want = jax.grad(lambda q: jnp.sum(jlstm.bilstm_layer_tm(
            q, jnp.asarray(x), rng=jax_key(key), compute_dtype=jnp.float32, **kw) * g))(
            {k: jnp.asarray(v) for k, v in p.items()})
        tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
        out = tlstm.bilstm_layer_tm(tp, torch.from_numpy(x), rng=key,
                                    compute_dtype=torch.float32, **kw)
        (out * torch.from_numpy(g)).sum().backward()
        for k in ("W", "U", "b"):
            w = np.asarray(want[k])
            assert np.abs(tp[k].grad.numpy() - w).max() <= TOL_F32 * np.abs(w).max(), (per_gate, k)
    shapes = {path[-1]: None for kind, path in jax_streams}
    assert set(shapes) == {0, 1}


# ------------------------------------------------------------------ fit


def _fit_cfg(**kw):
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                               output_dropout=0.0)
    over = dict(maxlen=T, batch_size=2, max_label_len=N, encoder=enc,
                compute_dtype="float32", patience=2,
                optimizer=cfglib.OptimizerConfig(learning_rate=0.05, decay=1e-5))
    over.update(kw)
    return cfglib.get_preset("skeletal").replace(**over)


def _corpus(cfg, n_files=8, seed=0):
    b = _batch(cfg, seed=seed, n=n_files)
    ids = list(range(100, 100 + n_files))
    args = (b["inputs"], b["labels"], b["label_length"], b["input_length"], ids)
    split = dict(train_ids=ids[:6], val_ids=ids[6:])
    return JBatcher(*args, **split), TBatcher(*args, **split)


def _slots(workdir):
    return sorted(f for f in os.listdir(workdir) if not f.endswith("metrics.jsonl"))


def test_fit_matches_jax_fit(tmp_path):
    """Per-epoch losses, the best epoch, the early-stop epoch and the
    slots written, on a tiny skeletal corpus in f32 with dropout and noise
    at 0; a learning rate high enough that val loss turns and patience 2
    stops the run."""
    cfg = _fit_cfg(reduce_lr_factor=0.5, reduce_lr_patience=1)
    jmodel, jparams, tmodel = _pair(cfg, seed=cfg.seed)
    jdata, tdata = _corpus(cfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres = jloop.fit(jmodel, jdata, workdir=jdir, epochs=12)
    tres = tloop.fit(tmodel, tdata, workdir=tdir, epochs=12)
    assert tres.epochs_run == jres.epochs_run < 12  # early stop, same epoch
    for key in ("train_loss", "val_loss", "grad_norm", "lr_scale"):
        got = [h[key] for h in tres.history]
        want = [h[key] for h in jres.history]
        np.testing.assert_allclose(got, want, rtol=TOL_F32, err_msg=key)
    assert abs(tres.best_val_loss - jres.best_val_loss) <= TOL_F32 * jres.best_val_loss
    best_epoch = int(np.argmin([h["val_loss"] for h in jres.history]))
    assert int(np.argmin([h["val_loss"] for h in tres.history])) == best_epoch
    assert _slots(tdir) == [
        "skeletal_best.params.pt", "skeletal_best.state.pt", "skeletal_config.json",
        "skeletal_fitmeta.json", "skeletal_latest.params.pt", "skeletal_latest.state.pt"]
    assert {"skeletal_best.msgpack", "skeletal_latest.msgpack"} <= set(_slots(jdir))
    jmeta = json.load(open(os.path.join(jdir, "skeletal_fitmeta.json")))
    tmeta = json.load(open(os.path.join(tdir, "skeletal_fitmeta.json")))
    assert tmeta.keys() == jmeta.keys() and tmeta["plateau"] == pytest.approx(jmeta["plateau"])
    assert tmeta["num_train_batches"] == jmeta["num_train_batches"] == 3

    # The best slot holds the best epoch's parameters (a fresh model
    # reloads them); the resume geometry guard refuses another corpus.
    fresh = tckpt.load_params(tdir, "skeletal", tbuild(_port(cfg), seed=9, device="cpu"), slot="best")
    assert all(torch.isfinite(v).all() for v in fresh.state_dict().values())
    _, small = _corpus(cfg, n_files=6)
    small.train_ids = small.train_ids[:4]
    for fit, data, wd in ((jloop.fit, JBatcher(small.features, small.labels,
                                              small.label_lengths, small.input_lengths,
                                              small.file_ids, small.train_ids,
                                              small.val_ids), jdir),
                          (tloop.fit, small, tdir)):
        model = jmodel if fit is jloop.fit else tmodel
        with pytest.raises(ValueError, match="geometry"):
            fit(model, data, workdir=wd, resume=True, epochs=20)


def test_fit_resume_draws_the_masks_of_an_unbroken_run(tmp_path):
    """With dropout and noise on: 2 epochs, then resume to 4, give the
    losses of 4 epochs in one run (each step's draws depend only on the
    seed and the step), with checkpoints every 2 epochs."""
    cfg = _fit_cfg(encoder=cfglib.EncoderConfig(hidden=8, depth=2), patience=50,
                   optimizer=cfglib.OptimizerConfig(learning_rate=1e-2))
    _, tdata = _corpus(cfg, seed=1)
    full = tloop.fit(tbuild(_port(cfg), device="cpu"), tdata, workdir=str(tmp_path / "a"), epochs=4,
                     checkpoint_every=2)
    wd = str(tmp_path / "b")
    first = tloop.fit(tbuild(_port(cfg), device="cpu"), tdata, workdir=wd, epochs=2, checkpoint_every=2)
    rest = tloop.fit(tbuild(_port(cfg), device="cpu"), tdata, workdir=wd, epochs=4, resume=True,
                     checkpoint_every=2)
    assert (first.epochs_run, rest.epochs_run) == (2, 2)
    got = [h["train_loss"] for h in first.history + rest.history]
    np.testing.assert_allclose(got, [h["train_loss"] for h in full.history], rtol=1e-6)
    assert rest.state.step == 12
    again = tloop.fit(tbuild(_port(cfg), device="cpu"), tdata, workdir=wd, epochs=4, resume=True)
    assert again.epochs_run == 0


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_cli"))
    sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
        root, n_files=10, frames_per_label=6, seed=2)
    return ["--skeletal-csv", sk_csv, "--labels", sk_labels]


def test_train_cli_matches_jax_cli(corpus, tmp_path, capsys, monkeypatch):
    """`train skeletal` through both CLIs on the same corpus and initial
    weights (dropout and noise at 0, f32): the same JSON result, config
    file and slots, and the port's decode reads what its train wrote."""
    from mgr_tpu.cli.main import main as jmain
    from mgr_tpu_torch.cli import main as tcli
    from mgr_tpu_torch.models import zoo

    cfg = _fit_cfg(maxlen=40)
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: cfg)
    monkeypatch.setitem(tconfig.PRESETS, "skeletal", lambda: _port(cfg))
    init = jax.tree.map(np.array, jbuild(cfg).init(jprng.root_key(cfg.seed)))
    real_build = zoo.build_model
    monkeypatch.setattr(zoo, "build_model", lambda c, **kw: bridge.load_params(
        real_build(c, **kw), init))

    def run(main, argv):
        assert main(argv) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    outs = {}
    for tag, main, dev in (("jax", jmain, []), ("torch", tcli.main, ["--device", "cpu"])):
        wd = str(tmp_path / tag)
        outs[tag] = run(main, ["train", "skeletal", "--workdir", wd, "--epochs", "3",
                               "--batch-size", "2", "--compute-dtype", "float32",
                               *dev, *corpus])
    assert outs["torch"]["epochs_run"] == outs["jax"]["epochs_run"] == 3
    assert outs["torch"]["best_val_loss"] == pytest.approx(outs["jax"]["best_val_loss"],
                                                           rel=TOL_F32)
    jcfg = json.load(open(tmp_path / "jax" / "skeletal_config.json"))
    tcfg = json.load(open(tmp_path / "torch" / "skeletal_config.json"))
    assert tcfg == jcfg and tcfg["batch_size"] == 2
    dec = run(tcli.main, ["decode", "skeletal", "--workdir", str(tmp_path / "torch"),
                          "--out", str(tmp_path / "t.mlf"), "--device", "cpu", *corpus])
    assert dec["decoded"] >= 1
    with pytest.raises(SystemExit, match="accum-steps"):
        tcli.main(["train", "skeletal", "--accum-steps", "0", "--device", "cpu", *corpus])


# ------------------------------------------------------------------ traps


def test_trap_a_adjoint_reads_the_rounded_streams():
    """K2 reads bf16 cs for tanh(c_t) and c_prev and bf16 hs for h_prev:
    feeding the f32 carries instead is a different function."""
    rng = np.random.default_rng(20)
    bf = torch.bfloat16
    xp = [torch.from_numpy(rng.standard_normal((T, B, 4, 8)).astype(np.float32)).to(bf)
          for _ in range(2)]
    U = torch.from_numpy(np.array(jlstm.init_bilstm_params(jax.random.key(0), 4, 8)["U"])).to(bf)
    g = [torch.from_numpy(rng.standard_normal((T, B, 8)).astype(np.float32)).to(bf)
         for _ in range(2)]
    stored = tlstm.bilstm_scan_tm_plain(*xp, U, store_c=True, out_dtype=bf)
    f32_streams = tlstm.bilstm_scan_tm_plain(*[x.float() for x in xp], U.float(), store_c=True)
    want = tlstm.bilstm_scan_tm_bwd_plain(*xp, U, *stored, *g)
    other = tlstm.bilstm_scan_tm_bwd_plain(*xp, U, *[s.to(bf) for s in stored], *g)
    assert all(torch.equal(a, b) for a, b in zip(want, other))
    wrong = tlstm.bilstm_scan_tm_bwd_plain(
        *[x.float() for x in xp], U.float(), *f32_streams, *[x.float() for x in g])
    assert not torch.equal(want[0].float(), wrong[0].to(bf).float())


def test_trap_b_hard_sigmoid_slope_is_zero_at_the_ends():
    z = torch.tensor([-2.5, -2.4999, 0.0, 2.4999, 2.5, 3.0])
    np.testing.assert_array_equal(tlstm.hard_sigmoid_grad(z).numpy(),
                                  np.float32([0.0, 0.2, 0.2, 0.2, 0.0, 0.0]))
    zg = z.clone().requires_grad_()
    tlstm.hard_sigmoid(zg).sum().backward()  # autograd of clamp: another function
    assert float(zg.grad[0]) != 0.0 or float(zg.grad[4]) != 0.0


def test_trap_c_cotangents_round_to_bf16_before_k2():
    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    xp = [torch.from_numpy(rng.standard_normal((T, B, 4, 8)).astype(np.float32)).to(bf)
          .requires_grad_() for _ in range(2)]
    U = torch.from_numpy(np.array(jlstm.init_bilstm_params(jax.random.key(1), 4, 8)["U"]))
    U.requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, T, B, 8)).astype(np.float32))
    grads = []
    for cot in (g, g.to(bf).float() * (1 + 2 ** -12)):  # same bf16 values
        for t in (*xp, U):
            t.grad = None
        hs0, hs1 = k1.BiLSTMTm.apply(*xp, U)
        (hs0 * cot[0] + hs1 * cot[1]).sum().backward()
        grads.append([t.grad.clone() for t in (*xp, U)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert grads[0][0].dtype == bf and grads[0][2].dtype == torch.float32


def test_trap_d_dropout_scales_in_bf16(monkeypatch):
    """Layer dropout scales by mask.astype(bf16) / keep in bf16 (keep 0.6:
    1.6640625, not 1/0.6); head dropout is x * mask / keep in h's dtype;
    noise is x + sigma * N(0, 1) in the f32 input's dtype."""
    scale = tlstm.dropout_scale(prng.root_key(0), 0.6, (64,), torch.bfloat16,
                                torch.device("cpu"))
    assert set(scale.float().unique().tolist()) <= {0.0, 1.6640625}
    assert float((jnp.ones((), jnp.bfloat16) / 0.6).astype(jnp.float32)) == 1.6640625
    x = np.random.default_rng(22).standard_normal((T, B, 8)).astype(np.float32)
    jk, key = jax.random.key(3), prng.root_key(3)
    monkeypatch.setattr(prng, "bernoulli", lambda k, p, shape, device: torch.from_numpy(
        np.array(jax.random.bernoulli(jk, p, shape))))
    monkeypatch.setattr(prng, "normal", lambda k, shape, dtype, device: torch.from_numpy(
        np.array(jax.random.normal(jk, shape, jnp.float32))))
    got = tlayers.dropout(torch.from_numpy(x).to(torch.bfloat16), 0.4, key, True)
    want = jlayers.dropout(jnp.asarray(x, jnp.bfloat16), 0.4, jk, True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    got = tlayers.gaussian_noise(torch.from_numpy(x), 0.5, key, True)
    want = jlayers.gaussian_noise(jnp.asarray(x), 0.5, jk, True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trap_e_projection_backward_is_explicit():
    """matmul_f32's backward is its own Function (the card's
    torch.mm(out_dtype=) cannot be relied on for autograd): the f32
    cotangent times the other operand, rounded to each operand's dtype,
    as JAX's VJP of a dot with preferred_element_type=float32."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((T * B, 5)).astype(np.float32)
    w = rng.standard_normal((5, 32)).astype(np.float32)
    g = rng.standard_normal((T * B, 32)).astype(np.float32)
    bf = torch.bfloat16
    xt = torch.from_numpy(x).to(bf).requires_grad_()
    wt = torch.from_numpy(w).to(bf).requires_grad_()
    y = tlstm.matmul_f32(xt, wt)
    assert y.grad_fn.__class__.__name__ == "_MatmulF32Backward"
    (y * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("nf,fk->nk", a, b,
                                             preferred_element_type=jnp.float32),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(dx.astype(jnp.float32)))
    np.testing.assert_array_equal(wt.grad.float().numpy(), np.asarray(dw.astype(jnp.float32)))


def test_trap_f_draws_follow_the_fold_path(jax_streams):
    """The port draws on the JAX package's fold paths: noise under
    "noise", layer i direction d under ("drop_i", d), the head under
    "head_drop"; its own draws depend on the path alone."""
    cfg = _speech_cfg()
    tmodel = tbuild(_port(cfg), device="cpu")
    key = prng.fold_in(prng.root_key(0), 5)
    with torch.no_grad():
        tmodel.apply_tm(torch.zeros((B, T, cfg.num_feats)), train=True, rng=key)
    assert [p[len(key.path):] for _, p in jax_streams] == [
        ("noise",), ("drop_0", 0), ("drop_0", 1), ("drop_1", 0), ("drop_1", 1), ("head_drop",)]


def test_trap_f_own_streams_are_reproducible():
    a = prng.fold_in(prng.fold_name(prng.root_key(1), "dropout"), 3)
    same = prng.bernoulli(a, 0.5, (1000,))
    assert torch.equal(same, prng.bernoulli(prng.Key(1, ("dropout", 3)), 0.5, (1000,)))
    assert not torch.equal(same, prng.bernoulli(prng.fold_in(prng.fold_name(
        prng.root_key(1), "dropout"), 4), 0.5, (1000,)))
    assert 0.4 < float(same.float().mean()) < 0.6


def test_trap_g_projection_rounds_once_in_train_mode():
    """With input dropout: x rounded to bf16, times the bf16 scale
    (rounded), then the f32 product plus the f32 bias, rounded once."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal((T, B, 5)).astype(np.float32)
    W = rng.standard_normal((5, 4, 8)).astype(np.float32)
    b = (1.0 + rng.standard_normal((4, 8)) * 1e-2).astype(np.float32)
    mask = rng.random((B, 5)) < 0.6
    bf = torch.bfloat16
    scale = torch.from_numpy(mask).to(bf) / torch.tensor(0.6, dtype=bf)
    got = tlstm.input_projection(torch.from_numpy(x).to(bf) * scale, torch.from_numpy(W),
                                 torch.from_numpy(b), bf)
    jscale = jnp.asarray(mask).astype(jnp.bfloat16) / 0.6
    xd = jnp.asarray(x, jnp.bfloat16) * jscale[None]
    want = (jnp.einsum("tbf,fgh->tbgh", xd, jnp.asarray(W, jnp.bfloat16),
                       preferred_element_type=jnp.float32) + b[None, None]).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
