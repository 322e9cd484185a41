"""Learning over a whole run: the port's ``fit`` held to the JAX package's
through the convergence check's skeletal stage, from one init and one set
of draws, long enough that the train loss leaves its floor.

The recipe is R1's (``examples/tpu_convergence_check.py`` and
``mgr_tpu_torch/examples/convergence_check.py``): each side's own
``_parity_overrides`` (input noise 0.05, per-gate dropout 0.02 with
output dropout 0.02, Adam 3e-3 with Keras decay 1e-5, maxnorm 3, patience
10,000) and each side's own ``_run`` (``fit`` with ``monitor="train"``,
``keep_best_state=True``, ``sync_every=10``, then the best state's train
split decoded by ``evaluate_accuracy``), on each side's
``make_skeletal_dataset(frames_per_label=24, max_labels=4, seed=4)``. The
geometry is cut through the drivers' knobs (``GEOMETRY``: T=96, the
hidden width scaled to 60, 10 files of which 8 train, B=8: one step an
epoch). The port starts from JAX's init (``bridge.load_params``) and draws
JAX's noise and masks (``torch_jax_draws.replay_jax_draws``).

The floor. At this geometry the loss falls from ~270 to ~10 in 30 epochs,
then slows near 7.5 and falls steadily: the long plateau of the full
geometry (~8.2 for hundreds of epochs at T=1900, where 95% of the frames
are padding) does not form at T=96. So the floor is the first 10-epoch
window (the drivers' sync window) whose mean train loss lies less than
``FALL`` below the window before it, and the escape is the first later
window ``FALL`` below that floor. The geometry, the seed (the preset's 47)
and the epoch counts were chosen from JAX's curve alone: its floor is
window 4 (epochs 40-49, 7.49), it escapes in window 7 (epochs 70-79, 6.36
in f32), and at 300 epochs in bf16 its best state decodes 10 of the 21
train tokens. Each case asserts that JAX's curve escapes within the run,
so it cannot pass vacuously.

Tolerances, each with its reason:
  * f32, the train loss of every epoch (the mean of its steps): 1e-4
    relative before the escape window (``TOL_F32_EPOCH``; measured at most
    3.9e-5, at epoch 69's loss spike), 2e-3 in it (``TOL_F32_ESCAPE``;
    measured 5.8e-4, at epoch 74). The two sides sum in another order (the
    XLA scan and its autodiff against the port's plain recurrence and
    written-out adjoint), so their parameters differ by a few f32 ulps
    each step; the escape's steps multiply a gap by about ten a window.
    JAX does the same to itself: with one weight of its init moved by one
    f32 ulp its per-epoch losses stay within 1.9e-6 of the unmoved run's
    through epoch 69, then part by 2.8e-5, 2.2e-4, 2e-3 and 1.4e-2 in the
    next four windows (``tests/torch_learning_runs.py nudge``). Resumed
    from one JAX slot at epoch 73, one step of each side agrees to 7e-8 in
    the loss and 2e-8 (relative Frobenius) in every parameter
    (``tests/torch_learning_runs.py bisect``). The case runs 80 epochs:
    through the escape window, not into the drift after it.
  * bf16, the production dtype: the window in which each side first
    falls ``FALL`` below JAX's floor is the same, or an adjacent, window;
    through it the window means agree to 1e-2 relative
    (``TOL_BF16_WINDOW``, 2.5 bf16 ulps; measured at most 3.4e-3). JAX runs
    its XLA scan here (its Pallas kernels in interpret mode would take
    hours), the port its plain versions, which round where the kernels do
    (h stored in bf16, the adjoint reading the bf16 streams).
  * The decoded train token accuracy of the best states after 300 epochs
    in bf16: within 0.05 (``TOL_ACCURACY``, one token of 21) of the band
    JAX spans against itself when one weight of its init moves by one
    bf16 ulp. After the escape the curves part as JAX's own pair does
    (per epoch, the port's losses within 22% of JAX's, the nudged run's
    within 42%), and a best state's decode is as sensitive: JAX decodes 0.4762,
    JAX nudged 0.2381, the port 0.3333. A plain 0.05 between the two sides
    would hold one pair of runs to a closeness JAX does not show against
    itself. Both f32 runs decode 0.0 at 80 epochs, and must agree.

The file alone takes 158 s on an 8-core Intel Xeon host (one torch
thread): the f32 case 37 s, the bf16 case 116 s (its three runs: JAX, the
port, JAX nudged).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import torch

from mgr_tpu.core import config as jconfig
from mgr_tpu.core import prng as jprng
from mgr_tpu.data import datasets as jdatasets
from mgr_tpu.data import synthetic as jsynthetic
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.train import loop as jloop
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data import datasets as tdatasets
from mgr_tpu_torch.data import synthetic as tsynthetic
from mgr_tpu_torch.examples import convergence_check
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.train import loop as tloop
from test_torch_examples import _load_jax
from torch_jax_draws import replay_jax_draws

torch.set_num_threads(1)

GEOMETRY = {"MGR_TPU_CONV_ONLY": "skeletal", "MGR_TPU_CONV_HIDDEN_SCALE": "0.2",
            "MGR_TPU_CONV_FILES": "10", "MGR_TPU_CONV_MAXLEN": "96",
            "MGR_TPU_CONV_BATCH": "8"}
WINDOW = 10  # the drivers' sync_every
FALL = 1.0
F32_EPOCHS, BF16_EPOCHS = 80, 300
NUDGED = "encoder.blstm_0.W"  # the leaf whose first entry a nudge moves
TOL_F32_EPOCH = 1e-4
TOL_F32_ESCAPE = 2e-3
TOL_BF16_WINDOW = 1e-2
TOL_ACCURACY = 0.05


def window_means(epoch_losses: np.ndarray) -> np.ndarray:
    """The mean train loss of each whole 10-epoch window."""
    n = len(epoch_losses) // WINDOW * WINDOW
    return epoch_losses[:n].reshape(-1, WINDOW).mean(axis=1)


def floor_and_escape(windows: np.ndarray):
    """(floor window, floor loss, escape window or None): the floor is the
    first window less than ``FALL`` below the one before it, the escape
    the first later window ``FALL`` below the floor."""
    w = next(i for i in range(1, len(windows)) if windows[i] > windows[i - 1] - FALL)
    floor = float(windows[w])
    return w, floor, first_below(windows, floor - FALL, after=w)


def first_below(windows: np.ndarray, level: float, after: int):
    return next((i for i in range(after + 1, len(windows)) if windows[i] <= level), None)


def _record_losses(monkeypatch, module, out: list) -> None:
    """``module.make_indexed_train_step`` (what each ``fit`` steps a corpus
    held on the device with) appends every step's loss to ``out``."""
    real = module.make_indexed_train_step

    def make(model):
        step = real(model)

        def recorded(*args):
            state, m = step(*args)
            out.append(float(m["loss"]))
            return state, m
        return recorded

    monkeypatch.setattr(module, "make_indexed_train_step", make)


def stage(dtype: str, epochs: int, monkeypatch, root, seed=None):
    """Both drivers' skeletal stage at ``GEOMETRY`` for ``epochs``, each
    side's corpus written under ``root``: (the JAX driver module, its
    config and corpus, the port's knobs, config and corpus). ``seed``
    replaces the preset's on both sides."""
    jax_driver = _load_jax("tpu_convergence_check",
                           {**GEOMETRY, "MGR_TPU_CONV_EPOCHS": str(epochs)}, monkeypatch)
    k = convergence_check.knobs()
    made = []
    for synthetic, side in ((jsynthetic, "jax"), (tsynthetic, "torch")):
        os.makedirs(os.path.join(root, side))
        made.append(synthetic.make_skeletal_dataset(
            os.path.join(root, side), n_files=k.files, frames_per_label=24, max_labels=4,
            seed=4)[:2])
    over = {"compute_dtype": dtype, **({} if seed is None else {"seed": seed})}
    jcfg = jax_driver._parity_overrides(jconfig.get_preset("skeletal"), 300).replace(**over)
    tcfg = convergence_check._parity_overrides(k, tconfig.get_preset("skeletal"), 300).replace(
        **over)
    assert tcfg.to_json() == jcfg.to_json()
    return (jax_driver, jcfg, jdatasets.build_skeletal_dataset(*made[0], jcfg),
            k, tcfg, tdatasets.build_skeletal_dataset(*made[1], tcfg))


def _per_epoch(losses: list, epochs: int) -> np.ndarray:
    return np.asarray(losses).reshape(epochs, -1).mean(axis=1)


def run_jax(monkeypatch, jax_driver, jcfg, jdata):
    """The JAX driver's ``_run``: (per-epoch train losses, its row)."""
    losses = []
    _record_losses(monkeypatch, jstep, losses)
    row = jax_driver._run("skeletal", jcfg, jdata)
    return _per_epoch(losses, row["epochs"]), row


def run_port(monkeypatch, k, tcfg, tdata, tmodel=None):
    """The port driver's ``_run`` on the CPU, on ``tmodel`` when given
    (else on the model the driver builds): (per-epoch train losses, its
    row)."""
    if tmodel is not None:
        monkeypatch.setattr(convergence_check, "build_model", lambda cfg, device: tmodel)
    losses = []
    _record_losses(monkeypatch, tloop, losses)
    row = convergence_check._run(k, tcfg, tdata, "cpu")
    assert row["epochs"] == k.epochs
    assert len(losses) == k.epochs * tdata.num_batches(tcfg.batch_size, train=True)
    return _per_epoch(losses, row["epochs"]), row


def bridged_model(jcfg, tcfg):
    """The port's model holding the init JAX's ``fit`` starts from
    (``init(root_key(seed))``); the port's ``fit`` starts from the model's
    weights."""
    jparams = jbuild(jcfg).init(jprng.root_key(jcfg.seed))
    return bridge.load_params(tbuild(tcfg, device="cpu"), jax.tree.map(np.array, jparams))


def both_runs(dtype: str, epochs: int, monkeypatch, root):
    """The stage from one init and JAX's draws: the per-epoch train losses
    (JAX, port), the two ``_run`` rows, and what :func:`stage` returned."""
    staged = stage(dtype, epochs, monkeypatch, root)
    jax_driver, jcfg, jdata, k, tcfg, tdata = staged
    drawn = replay_jax_draws(monkeypatch, with_shape=True)
    jloss, jrow = run_jax(monkeypatch, jax_driver, jcfg, jdata)
    tloss, trow = run_port(monkeypatch, k, tcfg, tdata, tmodel=bridged_model(jcfg, tcfg))
    _assert_every_draw_replayed(drawn, tcfg, epochs * tdata.num_batches(tcfg.batch_size,
                                                                         train=True))
    return jloss, tloss, jrow, trow, staged


def _assert_every_draw_replayed(drawn: list, cfg, n_steps: int) -> None:
    """Each step drew the input noise, the per-gate (4, B, F) masks of
    both directions of both layers, and the head's output dropout, all
    through JAX's streams; step s on fit's path ("dropout", s)."""
    B, H = cfg.batch_size, cfg.encoder.hidden
    gate_masks = {("drop_0", d): (4, B, cfg.num_feats) for d in (0, 1)}
    gate_masks.update({("drop_1", d): (4, B, 2 * H) for d in (0, 1)})
    per_step = {}
    for kind, path, shape in drawn:
        assert path[0] == "dropout"
        per_step.setdefault(path[1], []).append((kind, path[2:], shape))
    assert sorted(per_step) == list(range(n_steps))
    for step_draws in per_step.values():
        kinds = {(kind, suffix) for kind, suffix, _ in step_draws}
        assert kinds == {("normal", ("noise",)), ("bernoulli", ("head_drop",))} | {
            ("bernoulli", suffix) for suffix in gate_masks}
        assert len(step_draws) == len(kinds)
        for kind, suffix, shape in step_draws:
            if suffix in gate_masks:
                assert shape == gate_masks[suffix], (suffix, shape)


def nudge(params, dtype: str):
    """JAX params with one entry of ``NUDGED`` one ulp of ``dtype`` up (an
    f32 ulp would vanish in a bf16 run's casts)."""
    flat = {k: np.array(v) for k, v in bridge.flatten(params).items()}
    entry = flat[NUDGED].reshape(-1)
    entry[0] += np.spacing(entry[0]) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    return jax.tree.map(jax.numpy.asarray, bridge.unflatten(flat))


def run_jax_nudged(monkeypatch, jax_driver, jcfg, jdata):
    """:func:`run_jax` from JAX's init with one weight nudged by one ulp."""
    real = jloop.create_train_state

    def nudged(model, key):
        state = real(model, key)
        return state._replace(params=nudge(state.params, jcfg.compute_dtype))

    monkeypatch.setattr(jloop, "create_train_state", nudged)
    return run_jax(monkeypatch, jax_driver, jcfg, jdata)


def _jax_escapes(jwin: np.ndarray):
    w_floor, floor, w_escape = floor_and_escape(jwin)
    assert w_escape is not None, ("JAX's curve did not leave its floor", jwin)
    assert w_escape - w_floor >= 2, jwin  # it sat at the floor for a while first
    return w_floor, floor, w_escape


def test_f32_fit_tracks_jax_through_the_escape(monkeypatch, tmp_path):
    jloss, tloss, jrow, trow, _ = both_runs("float32", F32_EPOCHS, monkeypatch, str(tmp_path))
    _, _, w_escape = _jax_escapes(window_means(jloss))
    assert w_escape == F32_EPOCHS // WINDOW - 1  # the run ends with the escape window
    before = slice(0, w_escape * WINDOW)
    np.testing.assert_allclose(tloss[before], jloss[before], rtol=TOL_F32_EPOCH)
    np.testing.assert_allclose(tloss, jloss, rtol=TOL_F32_ESCAPE)
    assert abs(trow["train_accuracy"] - jrow["train_accuracy"]) <= TOL_ACCURACY


def test_bf16_fit_leaves_the_floor_with_jax(monkeypatch, tmp_path):
    jloss, tloss, jrow, trow, staged = both_runs("bfloat16", BF16_EPOCHS, monkeypatch,
                                                 str(tmp_path))
    jwin, twin = window_means(jloss), window_means(tloss)
    w_floor, floor, w_escape = _jax_escapes(jwin)
    t_escape = first_below(twin, floor - FALL, after=w_floor)
    assert t_escape is not None and abs(t_escape - w_escape) <= 1, (t_escape, w_escape)
    through = slice(0, w_escape + 1)
    np.testing.assert_allclose(twin[through], jwin[through], rtol=TOL_BF16_WINDOW)

    # The decoded accuracy of a best state past the escape: within
    # TOL_ACCURACY of the band JAX spans against itself, one ulp apart.
    _, nrow = run_jax_nudged(monkeypatch, *staged[:3])
    band = sorted((jrow["train_accuracy"], nrow["train_accuracy"]))
    assert jrow["train_accuracy"] > 0.0  # the decode compares learned states
    assert band[0] - TOL_ACCURACY <= trow["train_accuracy"] <= band[1] + TOL_ACCURACY, (
        trow, jrow, nrow)
