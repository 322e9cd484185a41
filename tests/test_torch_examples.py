"""The port's learning drivers (``mgr_tpu_torch/examples/{convergence_check,
generalization_check,curriculum_bench,skeletal_bias_ab}.py``) against the
JAX package's scripts (``examples/``), on the CPU at toy geometry.

Schedule parity: the JAX script (loaded from its file under a patched
environment) and the port's driver run with ``fit``, ``evaluate_accuracy``,
``build_model``, the graft and the slot writes replaced by one recorder,
which returns scripted results (so that a target is met at a chosen probe
and the finetune leg fires) and keeps every call: the stage, the config's
JSON, epochs, resume, monitor, stop_below, sync_every, the workdir, and a
digest of the corpus. The two sequences must be equal, except at the three
reference-side faults the port does not copy, each asserted here. Then
each driver's ``main(device="cpu")`` runs for real, the curriculum once
through ``python -m``, and without a card every driver raises, naming
``--device cpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mgr_tpu.core import config as jax_config
from mgr_tpu_torch.core import checkpoint as torch_ckpt
from mgr_tpu_torch.core import config as torch_config
from mgr_tpu_torch.examples import (common, convergence_check, curriculum_bench,
                                    generalization_check, skeletal_bias_ab)

TOL_FEATS = 1e-6  # tests/test_torch_data.py's, for the same readers
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"tpu_convergence_check": convergence_check,
        "generalization_check": generalization_check,
        "curriculum_bench": curriculum_bench,
        "skeletal_bias_ab": skeletal_bias_ab}


def _env(monkeypatch, env):
    """The environment holds ``env`` and no other ``MGR_TPU_*`` knob."""
    for key in [k for k in os.environ if k.startswith("MGR_TPU_")]:
        monkeypatch.delenv(key)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


# --- parse_stage_table ----------------------------------------------------

@pytest.mark.parametrize("raw, stage, default", [
    ("-3", "skeletal", None),                                  # a bare float
    ("speech:0.95,skeletal:0.9,late_fusion:0.85", "skeletal", None),  # a named table
    ("speech:0.95,skeletal:0.9", "late_fusion", 0.5),          # a stage that is absent
    ("", "speech", 0.25),                                      # an empty string
    (" speech : 0.5 , skeletal: 1e-4", "skeletal", None),      # whitespace
    ("speech:,skeletal:2", "speech", 7.0),                     # a name with no value
])
def test_parse_stage_table_matches_jax(raw, stage, default):
    got = torch_config.parse_stage_table(raw, stage, default=default)
    assert got == jax_config.parse_stage_table(raw, stage, default=default)


@pytest.mark.parametrize("raw", ["skeletal:1e-3x3+5e-4x4", "speech:1e-3x2;skeletal:1e-4x9",
                                 "skeletal:1e-3x", "skeletal:5x4+1x2", "skeletal:ax3", ""])
def test_pretrain_ladder_matches_jax(raw, monkeypatch):
    jax_mod = _load_jax("tpu_convergence_check", {"MGR_TPU_CONV_PRETRAIN_LADDER": raw},
                        monkeypatch)
    outs = []
    for fn in (jax_mod._pretrain_ladder, lambda s: convergence_check.pretrain_ladder(raw, s)):
        try:
            outs.append(fn("skeletal"))
        except SystemExit as e:
            outs.append(("exit", str(e)))
    assert outs[0] == outs[1]


# --- the recorder ---------------------------------------------------------

def _load_jax(script: str, env: dict, monkeypatch, argv=()):
    """Execute ``examples/<script>.py`` as a fresh module under ``env`` (its
    module-level code reads the environment; the chip lock is a no-op under
    JAX_PLATFORMS=cpu)."""
    _env(monkeypatch, env)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{script}", os.path.join(REPO, "examples", f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(data) -> tuple:
    """The corpus a fit call was given: its arrays (copied), the file ids
    and the split."""
    arrays = []
    for name in ("features", "labels", "label_lengths", "input_lengths"):
        x = getattr(data, name, None)
        arrays += [(name, np.array(a)) for a in (x if isinstance(x, tuple) else (x,))
                   if a is not None]
    return (arrays, tuple(int(i) for i in data.file_ids),
            tuple(int(i) for i in data.train_ids), tuple(int(i) for i in data.val_ids))


class _Clock:
    """``time`` for a recorded run: each reading a second after the last, so
    that every wall is positive."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 1.0
        return self.now


class _Model:
    def __init__(self, cfg):
        self.config = cfg

    def named_parameters(self):
        return iter(())


class _State(SimpleNamespace):
    def _replace(self, **kw):
        return _State(**{**vars(self), **kw})


class Recorder:
    """Stands in for ``fit``, ``evaluate_accuracy``, ``build_model``, the
    graft and the slot writes of one framework, and keeps every call.
    ``accuracy`` maps a stage to the accuracies its evaluations return, in
    order (the last one repeats)."""

    def __init__(self, root: str, ckpt, accuracy: dict):
        self.root, self.ckpt, self.accuracy = root, ckpt, accuracy
        self.calls, self.corpora, self.epoch = [], [], {}
        self.seen = {}

    def _rel(self, path):
        """A workdir relative to the run's directory, or to the temporary
        directory the driver made (whose name is random)."""
        if not path:
            return None
        rel = os.path.relpath(path, self.root)
        if rel.startswith(".."):
            rel = os.path.join("<tmp>", *os.path.relpath(path, tempfile.gettempdir())
                               .split(os.sep)[1:])
        return rel

    def fit(self, model, data, *, workdir=None, resume=False, epochs=None, checkpoint_every=1,
            monitor="val", keep_best_state=False, sync_every=1, stop_below=None,
            plateau_controller=None, **kw):
        assert not kw, kw
        cfg = model.config
        key = (workdir, cfg.name)
        nb = max(data.num_batches(cfg.batch_size, train=True), 1)
        start = self.epoch.get(key, 0) if resume and workdir else 0
        ctl = plateau_controller
        # fit's rule: a resume loads the fitmeta's plateau state into a
        # caller's controller only while that controller is pristine.
        restores = bool(resume and workdir and ctl is not None and ctl.is_pristine()
                        and "plateau" in self.ckpt.load_fit_meta(workdir, cfg.name))
        self.calls.append(("fit", cfg.name, json.loads(cfg.to_json()), epochs, resume,
                           monitor, stop_below, sync_every, checkpoint_every, keep_best_state,
                           self._rel(workdir), restores))
        self.corpora.append((cfg.name, _corpus(data)))
        end = max(start, epochs)
        if ctl is not None:
            for _ in range(start, end):  # a loss that never improves: the rate anneals
                ctl.update(10.0)
        if workdir:
            self.epoch[key] = end
            self.ckpt.save_fit_meta(workdir, cfg.name,
                                    {"plateau": ctl.state_dict()} if ctl is not None else {})
        state = SimpleNamespace(step=end * nb, params={})
        return SimpleNamespace(state=state, best_state=state if keep_best_state else None,
                               best_val_loss=1.0, epochs_run=end - start,
                               history=[{"wall_s": 0.01}] * (end - start))

    def evaluate(self, model, data, train_split=False, spec=None):
        name = model.config.name
        n = self.seen.get(name, 0)
        self.seen[name] = n + 1
        seq = self.accuracy.get(name, [0.5])
        self.calls.append(("evaluate", name, train_split,
                           None if spec is None else (spec.threshold, spec.drop_blank)))
        return {"accuracy": seq[min(n, len(seq) - 1)], "wer": 0.5}

    def graft(self, workdir, cfg, sources, slot="best"):
        self.calls.append(("graft", cfg.name, self._rel(workdir), slot,
                           sorted((k, json.loads(v.to_json())) for k, v in sources.items())))
        return _Model(cfg)

    def save(self, workdir, stamp, state, slot):
        self.calls.append(("save", stamp, self._rel(workdir), slot))


def _run_jax(script, env, root, accuracy, monkeypatch, argv=()):
    import mgr_tpu.core.checkpoint as ckpt
    import mgr_tpu.decode.evaluate as evaluate
    import mgr_tpu.models as models
    import mgr_tpu.train.curriculum as curriculum
    import mgr_tpu.train.loop as loop
    import mgr_tpu.train.step as step

    mod = _load_jax(script, env, monkeypatch, argv)
    rec = Recorder(root, ckpt, accuracy)

    def evaluate_jax(model, params, data, *, train_split=False, spec=None, **kw):
        return rec.evaluate(model, data, train_split=train_split, spec=spec)

    def build(cfg, source_configs=None, **kw):
        return _Model(cfg)

    for target in (mod, evaluate):
        monkeypatch.setattr(target, "evaluate_accuracy", evaluate_jax, raising=False)
    for target in (mod, models):
        monkeypatch.setattr(target, "build_model", build, raising=False)
    monkeypatch.setattr(mod, "fit", rec.fit, raising=False)
    monkeypatch.setattr(mod, "time", _Clock())
    monkeypatch.setattr(curriculum, "build_fusion_with_pretrained",
                        lambda wd, cfg, srcs, slot="best": (rec.graft(wd, cfg, srcs, slot), {}))
    monkeypatch.setattr(step, "create_train_state",
                        lambda model, key: _State(params={}, step=0))
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda wd, stamp, state, slot="latest": rec.save(wd, stamp, state, slot))
    for target in (mod, loop):
        monkeypatch.setattr(target, "load_params_for_eval", lambda model, wd, slot="best": {},
                            raising=False)
    return rec, _call_main(mod.main)


def _run_port(script, env, root, accuracy, monkeypatch, argv=()):
    drv = PORT[script]
    _env(monkeypatch, env)
    rec = Recorder(root, torch_ckpt, accuracy)
    monkeypatch.setattr(drv, "fit", rec.fit)
    monkeypatch.setattr(drv, "evaluate_accuracy", rec.evaluate)
    monkeypatch.setattr(drv, "time", _Clock())
    monkeypatch.setattr(drv, "build_model",
                        lambda cfg, source_configs=None, *, device: _Model(cfg))
    if hasattr(drv, "build_fusion_with_pretrained"):
        monkeypatch.setattr(drv, "build_fusion_with_pretrained",
                            lambda wd, cfg, srcs, slot="best", *, device:
                            rec.graft(wd, cfg, srcs, slot))
        monkeypatch.setattr(drv, "create_train_state",
                            lambda model: _State(params={}, step=0))
    monkeypatch.setattr(torch_ckpt, "save_train_state",
                        lambda wd, stamp, state, *, slot="latest": rec.save(wd, stamp, state,
                                                                            slot))
    monkeypatch.setattr(torch_ckpt, "load_params", lambda wd, stamp, model, *, slot="best": model)
    return rec, _call_main(lambda: drv.main(*argv, device="cpu"))


def _call_main(main):
    """``main()``'s exit code: 0, or its SystemExit's."""
    try:
        main()
    except SystemExit as e:
        return e.code
    return 0


# --- the toy environments of tests/test_examples.py, and r5b's tables -----

_CONV_TOY = {"MGR_TPU_CONV_HIDDEN_SCALE": "0.02", "MGR_TPU_CONV_FILES": "6",
             "MGR_TPU_CONV_EPOCHS": "2", "MGR_TPU_CONV_MAXLEN": "64",
             "MGR_TPU_CONV_BATCH": "2"}
_CONV_FUSION = {**_CONV_TOY, "MGR_TPU_CONV_ONLY": "late_fusion", "MGR_TPU_CONV_PRETRAIN": "2",
                "MGR_TPU_CONV_FUSION_FPL": "4", "MGR_TPU_CONV_FUSION_LABELS": "3"}
_CB_TOY = {"MGR_TPU_CB_NTRAIN": "4", "MGR_TPU_CB_NVAL": "2", "MGR_TPU_CB_EPOCHS": "2",
           "MGR_TPU_CB_MAXLEN": "16", "MGR_TPU_CB_BATCH": "2",
           "MGR_TPU_CB_HIDDEN_SCALE": "0.02"}
_GEN_TOY = {"MGR_TPU_GEN_FILES": "10", "MGR_TPU_GEN_EPOCHS": "3", "MGR_TPU_GEN_MAXLEN": "64",
            "MGR_TPU_GEN_BATCH": "2", "MGR_TPU_GEN_FPL": "6", "MGR_TPU_GEN_LABELS": "3",
            "MGR_TPU_GEN_HIDDEN_SCALE": "0.02", "MGR_TPU_GEN_SYNC": "1",
            "MGR_TPU_GEN_PATIENCE": "2"}
_AB_TOY = {"MGR_TPU_AB_FILES": "4", "MGR_TPU_AB_MAXLEN": "32", "MGR_TPU_AB_FPL": "6",
           "MGR_TPU_AB_LABELS": "3", "MGR_TPU_AB_SCALE": "0.02", "MGR_TPU_AB_BATCH": "2",
           "MGR_TPU_AB_EPOCHS1": "2", "MGR_TPU_AB_EPOCHS2": "1", "MGR_TPU_AB_BIAS": "-2.0"}
# (script, env, argv, scripted accuracies, the exit code both must give);
# "{root}" in an env value is the run's own directory.
CASES = {
    "conv_default": ("tpu_convergence_check", _CONV_TOY, (), {}, 0),
    "conv_late_fusion": ("tpu_convergence_check", {
        **_CONV_FUSION, "MGR_TPU_CONV_PRETRAIN_LR2": "1e-3",
        "MGR_TPU_CONV_PRETRAIN_EPOCHS2": "1",
        "MGR_TPU_CONV_PRETRAIN_LADDER": "skeletal:1e-3x3+5e-4x4",
        "MGR_TPU_CONV_PRETRAIN_BLANK_BIAS": "skeletal:-3", "MGR_TPU_CONV_LR2": "1e-3",
        "MGR_TPU_CONV_EPOCHS2": "1", "MGR_TPU_CONV_FINETUNE": "1",
        "MGR_TPU_CONV_FUSION_BATCH": "3", "MGR_TPU_CONV_GUARD": "1",
        "MGR_TPU_CONV_PLATEAU": "0.5:2:1e-4:1e-3", "MGR_TPU_CONV_BLANK_BIAS": "-2.0"},
        (), {}, 0),
    "conv_fusion_default_batch": ("tpu_convergence_check",
                                  {**_CONV_FUSION, "MGR_TPU_CONV_ROOT": "{root}/corpus"},
                                  (), {}, 0),
    "conv_encoder_gate": ("tpu_convergence_check",
                          {**_CONV_FUSION, "MGR_TPU_CONV_REQUIRE_ENC": "1.1",
                           "MGR_TPU_CONV_ROOT": "{root}/corpus"}, (), {}, 3),
    "conv_rgb": ("tpu_convergence_check", {
        **_CONV_TOY, "MGR_TPU_CONV_ONLY": "rgb", "MGR_TPU_CONV_RGB_MAXLEN": "16",
        "MGR_TPU_CONV_RGB_FILES": "4", "MGR_TPU_CONV_RGB_BATCH": "2"}, (), {}, 0),
    "conv_early_fusion": ("tpu_convergence_check",
                          {**_CONV_TOY, "MGR_TPU_CONV_ONLY": "early_fusion"}, (), {}, 0),
    "ab_biased": ("skeletal_bias_ab", {**_AB_TOY, "MGR_TPU_AB_ROOT": "{root}/corpus",
                                       "MGR_TPU_AB_WORKDIR": "{root}/wd"}, ("biased",), {}, 0),
    "ab_unbiased": ("skeletal_bias_ab", {**_AB_TOY, "MGR_TPU_AB_ROOT": "{root}/corpus",
                                         "MGR_TPU_AB_WORKDIR": "{root}/wd"},
                    ("unbiased",), {}, 0),
    "cb_short": ("curriculum_bench", _CB_TOY, (), {}, 0),
    "cb_measured": ("curriculum_bench", {
        **_CB_TOY, "MGR_TPU_CB_MEASURED": "1",
        "MGR_TPU_CB_ACC_TARGET": "speech:0.0,late_fusion:2.0", "MGR_TPU_CB_ACC_EVERY": "1",
        "MGR_TPU_CB_BLANK_BIAS": "-3", "MGR_TPU_CB_FINETUNE_EPOCHS": "1"}, (), {}, 0),
    # examples/chip_campaign_r5b.sh:72-84 at toy widths: speech meets its
    # target at the second probe, skeletal at the first, late fusion never,
    # so its finetune leg runs its 3000 epochs in probes of 400.
    "cb_r5b": ("curriculum_bench", {
        "MGR_TPU_CB_MEASURED": "1", "MGR_TPU_CB_NTRAIN": "64", "MGR_TPU_CB_NVAL": "16",
        "MGR_TPU_CB_EPOCHS": "16000", "MGR_TPU_CB_WORKDIR": "{root}/curriculum_1cmd_wd",
        "MGR_TPU_CB_ACC_TARGET": "speech:0.95,skeletal:0.9,late_fusion:0.85",
        "MGR_TPU_CB_ACC_EVERY": "400",
        "MGR_TPU_CB_STAGE_BATCH": "speech:32,skeletal:32,late_fusion:8",
        "MGR_TPU_CB_STAGE_LR": "speech:3e-3,skeletal:3e-3,late_fusion:1e-4",
        "MGR_TPU_CB_BLANK_BIAS": "speech:-3,skeletal:-3,late_fusion:-3",
        "MGR_TPU_CB_SYNC_EVERY": "10", "MGR_TPU_CB_FINETUNE_EPOCHS": "3000",
        "MGR_TPU_CB_FINETUNE_LR": "3e-4", "MGR_TPU_CB_MAXLEN": "16",
        "MGR_TPU_CB_HIDDEN_SCALE": "0.02"},
        (), {"speech": [0.5, 0.96], "skeletal": [0.91], "late_fusion": [0.3]}, 0),
    "gen_smoke": ("generalization_check", _GEN_TOY, (), {}, 0),
    "gen_fusion": ("generalization_check", {
        **_GEN_TOY, "MGR_TPU_GEN_ONLY": "late_fusion", "MGR_TPU_GEN_FUSION_BATCH": "2",
        "MGR_TPU_GEN_RLR": "late_fusion:0.5/1/1e-5"}, (), {}, 0),
    # All three stages under a persistent root (chip_campaign_r5.sh's
    # layout): the uni-modal and fusion corpora and their pretrains.
    "gen_all_root": ("generalization_check", {
        **_GEN_TOY, "MGR_TPU_GEN_ONLY": "speech,skeletal,late_fusion",
        "MGR_TPU_GEN_ROOT": "{root}/root_gen", "MGR_TPU_GEN_GUARD": "1"}, (), {}, 0),
    "gen_require_enc": ("generalization_check", {
        **_GEN_TOY, "MGR_TPU_GEN_ONLY": "late_fusion", "MGR_TPU_GEN_ROOT": "{root}/root_gen",
        "MGR_TPU_GEN_REQUIRE_ENC": "0.9"},
        (), {"speech": [0.95], "skeletal": [0.4]}, 3),
}

_RUNS = {}


def _both(case, tmp_path_factory, monkeypatch):
    """Both frameworks' recorders for a case (each side once per session)."""
    if case not in _RUNS:
        script, env, argv, accuracy, _ = CASES[case]
        out = {}
        for side, run in (("jax", _run_jax), ("port", _run_port)):
            root = str(tmp_path_factory.mktemp(f"{case}_{side}"))
            side_env = {k: v.replace("{root}", root) for k, v in env.items()}
            with monkeypatch.context() as mp:
                rec, code = run(script, side_env, root, accuracy, mp, argv)
            out[side] = (rec, code, root)
        _RUNS[case] = out
    return _RUNS[case]


def _finetune_call(calls):
    """The index of the finetune leg's first fit (``finetune_encoders``)."""
    return next((i for i, c in enumerate(calls)
                 if c[0] == "fit" and c[2]["finetune_encoders"] and c[4]), None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax(case, tmp_path_factory, monkeypatch):
    runs = _both(case, tmp_path_factory, monkeypatch)
    (jrec, jcode, jroot), (prec, pcode, proot) = runs["jax"], runs["port"]
    assert jcode == pcode == CASES[case][4]
    jcalls, pcalls = list(jrec.calls), list(prec.calls)
    assert any(c[0] == "fit" for c in jcalls)
    # Fault 1 (examples/curriculum_bench.py, the finetune leg): JAX's fresh
    # controller takes the frozen leg's annealed state through the resume;
    # the port's finetune leg starts at its own LR with a pristine one.
    i = _finetune_call(jcalls)
    if case in ("cb_measured", "cb_r5b"):
        assert i is not None and i == _finetune_call(pcalls)
        assert jcalls[i][11] is True and pcalls[i][11] is False
        pcalls[i] = pcalls[i][:11] + (True,) + pcalls[i][12:]
    # Fault 3 (examples/generalization_check.py, the shared stamps): under a
    # persistent root the fusion stage's pretrains write under a workdir of
    # their own; JAX's resume the uni-modal stages' slots of another corpus.
    if "MGR_TPU_GEN_ROOT" in CASES[case][1]:
        wd = os.path.join("root_gen", "workdir")
        own = os.path.join(wd, "late_fusion")
        jfits = [c for c in jcalls if c[0] == "fit"]
        pfits = [c for c in pcalls if c[0] == "fit"]
        n_uni = 2 if case == "gen_all_root" else 0  # the uni-modal stages' fits
        assert {c[10] for c in pfits[n_uni:]} == {own}
        assert {c[10] for c in jfits[n_uni:]} == {wd}
        if case == "gen_all_root":
            uni, fus = jfits[:2], jfits[2:4]
            assert [(c[1], c[10]) for c in uni] == [(c[1], c[10]) for c in fus]  # shared
            assert [c[4] for c in fus] == [True, True]  # ... and resumed
            assert {c[10] for c in pfits[:2]} == {wd}
        pcalls = [tuple(wd if x == own else x for x in c) for c in pcalls]
    assert pcalls == jcalls


@pytest.mark.parametrize("case", sorted(CASES))
def test_corpus_matches_jax(case, tmp_path_factory, monkeypatch):
    """Every fit call's corpus is the JAX script's: the file ids and the
    split exactly, labels and lengths exactly, features within the
    readers' tolerance (``tests/test_torch_data.py``: the skeletal z-score
    sums in another order)."""
    runs = _both(case, tmp_path_factory, monkeypatch)
    jc, pc = runs["jax"][0].corpora, runs["port"][0].corpora
    assert jc and [c[0] for c in jc] == [c[0] for c in pc]
    for (stage, j), (_, p) in zip(jc, pc):
        assert j[1:] == p[1:], f"{stage}: file ids or split"
        assert [(n, a.dtype, a.shape) for n, a in j[0]] == \
            [(n, a.dtype, a.shape) for n, a in p[0]], stage
        for (name, ja), (_, pa) in zip(j[0], p[0]):
            if name == "features":
                np.testing.assert_allclose(pa, ja, atol=TOL_FEATS, rtol=0)
            else:
                np.testing.assert_array_equal(pa, ja)


def test_requeue_drops_the_failed_pretrain(tmp_path_factory, monkeypatch):
    """Fault 2 (examples/generalization_check.py, the REQUIRE_ENC abort):
    JAX drops the failed pretrain's sentinel but keeps its checkpoints, so
    a relaunch resumes the failed state; the port drops both. The pretrain
    that passed keeps its sentinel and checkpoints on both sides."""
    runs = _both("gen_require_enc", tmp_path_factory, monkeypatch)

    def files(root):
        wd = os.path.join(root, "root_gen", "workdir")
        top = os.path.join(root, "root_gen")
        return ({f for f in os.listdir(top) if f.startswith("pretrain_")},
                {f for d in (wd, os.path.join(wd, "late_fusion")) if os.path.isdir(d)
                 for f in os.listdir(d)})

    j_sent, j_wd = files(runs["jax"][2])
    p_sent, p_wd = files(runs["port"][2])
    assert j_sent == p_sent == {"pretrain_speech.json"}
    assert "skeletal_fitmeta.json" in j_wd and "speech_fitmeta.json" in j_wd
    assert "speech_fitmeta.json" in p_wd
    assert not any(f.startswith("skeletal_") for f in p_wd)


@pytest.mark.parametrize("case", ["conv_default", "conv_late_fusion", "conv_rgb"])
def test_convergence_check_seed_knob_reaches_every_stage(case, tmp_path, monkeypatch):
    """``MGR_TPU_CONV_SEED``, the port's one knob beyond the JAX script's,
    sets every stage's config seed; unset, the schedule parity above holds
    the presets' seed."""
    script, env, argv, accuracy, code = CASES[case]
    rec, got = _run_port(script, {**env, "MGR_TPU_CONV_SEED": "5"}, str(tmp_path), accuracy,
                         monkeypatch, argv)
    seeds = {c[2]["seed"] for c in rec.calls if c[0] == "fit"}
    assert got == code and seeds == {5}


# --- end to end on the CPU ------------------------------------------------

@pytest.mark.parametrize("only, keys", [
    ("", {"speech": {"train_accuracy", "train_wer", "epochs", "best_train_loss"},
          "skeletal": {"train_accuracy", "train_wer", "epochs", "best_train_loss"}}),
    ("late_fusion", {"late_fusion": {"train_accuracy", "train_accuracy_no_threshold",
                                     "encoder_train_accuracy", "anneal_epochs",
                                     "finetune_encoders", "best_train_loss"}}),
    ("rgb", {"rgb": {"train_accuracy", "best_train_loss"}}),
    ("early_fusion", {"early_fusion": {"train_accuracy", "best_train_loss"}}),
])
def test_convergence_check_runs_on_the_cpu(only, keys, monkeypatch, tmp_path):
    env = dict(CASES["conv_late_fusion"][1] if only == "late_fusion" else _CONV_TOY,
               MGR_TPU_CONV_ONLY=only, MGR_TPU_CONV_RGB_MAXLEN="16",
               MGR_TPU_CONV_RGB_FILES="4", MGR_TPU_CONV_RGB_BATCH="2")
    _env(monkeypatch, env)
    row = convergence_check.main(device="cpu")
    assert row["metric"] == "tpu_production_path_convergence"
    for stage, want in keys.items():
        assert want <= set(row[stage]) and np.isfinite(row[stage]["best_train_loss"])
    if only == "late_fusion":
        lf = row["late_fusion"]
        assert lf["anneal_epochs"] == 1 and lf["finetune_encoders"] is True
        assert set(lf["encoder_train_accuracy"]) == {"speech", "skeletal"}


def test_convergence_check_encoder_gate_exits_3(monkeypatch, tmp_path, capsys):
    _env(monkeypatch, {**_CONV_FUSION, "MGR_TPU_CONV_REQUIRE_ENC": "1.1",
                       "MGR_TPU_CONV_ROOT": str(tmp_path)})
    with pytest.raises(SystemExit) as e:
        convergence_check.main(device="cpu")
    assert e.value.code == 3
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["aborted"] == "encoder_below_floor"
    assert set(out["encoder_train_accuracy"]) == {"speech", "skeletal"}


@pytest.mark.parametrize("only", ["speech,skeletal", "late_fusion"])
def test_generalization_check_runs_on_the_cpu(only, monkeypatch):
    env = dict(CASES["gen_fusion"][1] if only == "late_fusion" else _GEN_TOY,
               MGR_TPU_GEN_ONLY=only, MGR_TPU_GEN_EPOCHS="2")
    _env(monkeypatch, env)
    row = generalization_check.main(device="cpu")
    assert row["metric"] == "heldout_generalization"
    stages = ("pretrain_speech", "pretrain_skeletal", "late_fusion") \
        if only == "late_fusion" else ("speech", "skeletal")
    for stage in stages:
        assert {"val_accuracy", "val_wer", "train_accuracy", "generalization_gap",
                "early_stopped", "best_val_loss"} <= set(row[stage])
        assert row[stage]["epochs_run"] <= 2 and np.isfinite(row[stage]["best_val_loss"])


def test_curriculum_bench_measured_runs_on_the_cpu(monkeypatch):
    """The measured mode at toy geometry: the chunked accuracy probes, the
    speech stage stopped at its first probe, and the finetune continuation
    forced by an impossible late-fusion target (the rebuild with unfrozen
    encoders resumes the frozen leg's slot)."""
    _env(monkeypatch, CASES["cb_measured"][1])
    out = curriculum_bench.main(device="cpu")
    assert out["measured"] is True and out["measured_total_s"] > 0
    for stage in out["stages"].values():
        assert "train_accuracy" in stage and "epochs_run" in stage
    assert out["stages"]["speech"]["reached_accuracy_target"] is True
    assert out["stages"]["speech"]["epochs_run"] == 1
    lf = out["stages"]["late_fusion"]
    assert lf["reached_accuracy_target"] is False
    assert lf["finetune_epochs"] == 1 and lf["epochs_run"] == 3


def test_curriculum_bench_entry_point_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MGR_TPU_")}
    proc = subprocess.run(
        [sys.executable, "-m", "mgr_tpu_torch.examples.curriculum_bench", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**env, **_CB_TOY})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == "curriculum_wall_clock"
    assert set(out["stages"]) == {"speech", "skeletal", "late_fusion"}
    assert all(s["epoch_s"] > 0 for s in out["stages"].values())


def test_skeletal_bias_ab_runs_on_the_cpu(monkeypatch, tmp_path):
    for arm, bias in (("biased", -2.0), ("unbiased", 0.0)):
        _env(monkeypatch, {**_AB_TOY, "MGR_TPU_AB_ROOT": str(tmp_path / "corpus"),
                           "MGR_TPU_AB_WORKDIR": str(tmp_path / f"wd_{arm}")})
        row = skeletal_bias_ab.main(arm, device="cpu")
        assert row["arm"] == arm and row["head_blank_bias"] == bias
        assert "train_accuracy" in row and np.isfinite(row["best_train_loss"])


# --- no card --------------------------------------------------------------

@pytest.mark.parametrize("script", sorted(PORT))
def test_without_a_card_each_driver_names_device_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        PORT[script].main(device="cuda")


def test_without_a_card_the_command_fails_naming_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "mgr_tpu_torch.examples.skeletal_bias_ab", "biased"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr


def test_params_loaded_gives_the_weights_back():
    """``params_loaded`` evaluates a state's parameters and leaves the
    module's own in place (the JAX drivers pass parameters to
    ``evaluate_accuracy``; the port's scores the module)."""
    model = torch.nn.Linear(3, 2)
    own = {k: v.detach().clone() for k, v in model.named_parameters()}
    other = {k: torch.full_like(v, 7.0) for k, v in own.items()}
    with common.params_loaded(model, other):
        assert torch.equal(model.weight, other["weight"])
    with contextlib.suppress(ValueError), common.params_loaded(model, other):
        raise ValueError
    assert all(torch.equal(p, own[k]) for k, p in model.named_parameters())
