"""Longer CPU runs behind ``tests/test_torch_learning_parity.py``, outside
tier-1: the convergence check's skeletal stage at the test's geometry
(``GEOMETRY`` there), each run printing one JSON line.

    JAX_PLATFORMS=cpu python tests/torch_learning_runs.py seed S [--epochs 300]
        Both sides under config seed S, each from its own init with its
        own draws (JAX's threefry, the port's Philox): where each leaves
        the floor, its curve, and the decoded train token accuracy of its
        best state. Five seeds give the spread of the draws.

    JAX_PLATFORMS=cpu python tests/torch_learning_runs.py nudge [--dtype float32] [--epochs 120]
        From the one init and JAX's draws as the test: JAX, JAX with one
        weight of the init moved by one ulp, and the port; the per-epoch
        gaps of JAX's own pair beside the gaps of JAX and the port.

    JAX_PLATFORMS=cpu python tests/torch_learning_runs.py bisect --epoch E [--dtype float32] [--more 16]
        JAX's ``fit`` to epoch E writes its slot; both sides resume from
        that one slot (the port through ``load_jax_train_state``), with
        JAX's draws: the parameters after one more step leaf by leaf, then
        the per-epoch losses of ``--more`` epochs.

Run the seeds in parallel as separate processes: at 300 epochs in bf16
each took 2-3 minutes on an 8-core Intel Xeon host with five at once;
``nudge`` and ``bisect`` take a minute or two there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (the suite's JAX settings: CPU, 8 devices, f32 dots)
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_learning_parity as lp  # noqa: E402
from mgr_tpu.train import loop as jloop  # noqa: E402
from mgr_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from mgr_tpu_torch.train import loop as tloop  # noqa: E402
from torch_jax_draws import replay_jax_draws  # noqa: E402

LEVEL = 6.5  # the parity test's escape level: JAX's bf16 floor at seed 47, less FALL


def _curve(loss: np.ndarray, row: dict) -> dict:
    """Where the curve leaves its own floor, and first reaches ``LEVEL``."""
    win = lp.window_means(loss)
    w_floor, floor, w_escape = lp.floor_and_escape(win)
    return {"floor_window": w_floor, "floor": round(floor, 4), "escape_window": w_escape,
            "first_window_at_level": lp.first_below(win, LEVEL, after=0),
            "windows": [round(float(w), 4) for w in win],
            "train_accuracy": row["train_accuracy"], "best_train_loss": row["best_train_loss"],
            "wall_s": row["wall_s"]}


def seed_run(seed: int, epochs: int, dtype: str) -> dict:
    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as root:
        jax_driver, jcfg, jdata, k, tcfg, tdata = lp.stage(dtype, epochs, mp, root, seed=seed)
        jloss, jrow = lp.run_jax(mp, jax_driver, jcfg, jdata)
    with pytest.MonkeyPatch.context() as mp:
        tloss, trow = lp.run_port(mp, k, tcfg, tdata)
    return {"run": "seed", "seed": seed, "dtype": dtype, "epochs": epochs,
            "jax": _curve(jloss, jrow), "port": _curve(tloss, trow)}


def nudge_run(epochs: int, dtype: str) -> dict:
    losses, rows = {}, {}
    for name in ("jax", "jax_nudged", "port"):
        with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as root:
            jax_driver, jcfg, jdata, k, tcfg, tdata = lp.stage(dtype, epochs, mp, root)
            if name == "port":
                replay_jax_draws(mp)
                losses[name], rows[name] = lp.run_port(mp, k, tcfg, tdata,
                                                       tmodel=lp.bridged_model(jcfg, tcfg))
            else:
                run = lp.run_jax_nudged if name == "jax_nudged" else lp.run_jax
                losses[name], rows[name] = run(mp, jax_driver, jcfg, jdata)
    ref = losses["jax"]
    gaps = {name: np.abs(losses[name] - ref) / np.abs(ref) for name in ("jax_nudged", "port")}
    return {"run": "nudge", "dtype": dtype, "epochs": epochs, "nudged": lp.NUDGED,
            "decoded": {name: {"train_accuracy": r["train_accuracy"],
                               "best_train_loss": r["best_train_loss"]}
                        for name, r in rows.items()},
            "per_epoch_rel_gap": {name: [float(f"{g:.3g}") for g in gap]
                                  for name, gap in gaps.items()},
            "max_rel_gap_by_window": {name: [float(f"{g:.3g}") for g in
                                             gap[: len(gap) // 10 * 10].reshape(-1, 10).max(1)]
                                      for name, gap in gaps.items()}}


def _fit_kw(k) -> dict:
    return dict(monitor="train", keep_best_state=True, sync_every=k.sync)


def bisect_run(epoch: int, more: int, dtype: str) -> dict:
    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as root:
        jax_driver, jcfg, jdata, k, tcfg, tdata = lp.stage(dtype, epoch, mp, root)
        jmodel = jax_driver.build_model(jcfg)
        # JAX's own run to the slot (its draws are the ones the port replays).
        jloop.fit(jmodel, jdata, workdir=os.path.join(root, "slot"), epochs=epoch,
                  **_fit_kw(k))
        for side in ("jax_wd", "port_wd"):
            shutil.copytree(os.path.join(root, "slot"), os.path.join(root, side))
        replay_jax_draws(mp)
        tmodel = lp.bridged_model(jcfg, tcfg)
        out = {"run": "bisect", "dtype": dtype, "slot_epoch": epoch}
        for upto in (epoch + 1, epoch + 1 + more):
            jlosses, tlosses = [], []
            with pytest.MonkeyPatch.context() as rec:
                lp._record_losses(rec, lp.jstep, jlosses)
                lp._record_losses(rec, tloop, tlosses)
                jloop.fit(jmodel, jdata, workdir=os.path.join(root, "jax_wd"), resume=True,
                          epochs=upto, **_fit_kw(k))
                tloop.fit(tmodel, tdata, workdir=os.path.join(root, "port_wd"), resume=True,
                          epochs=upto, **_fit_kw(k))
            if upto == epoch + 1:
                want = tckpt.read_jax_checkpoint(os.path.join(root, "jax_wd"), jcfg.name)
                want = {n: np.asarray(v, np.float64)
                        for n, v in lp.bridge.flatten(want["params"]).items()}
                got = torch.load(os.path.join(root, "port_wd", f"{tcfg.name}_latest.state.pt"),
                                 weights_only=False)["params"]
                out["one_step_loss"] = {"jax": jlosses[0], "port": tlosses[0]}
                out["one_step_rel_frobenius"] = {
                    n: float(f"{np.linalg.norm(got[n].double().numpy() - w) / max(np.linalg.norm(w), 1e-30):.3g}")
                    for n, w in want.items()}
                out["one_step_max_abs"] = {
                    n: float(f"{np.abs(got[n].double().numpy() - w).max():.3g}")
                    for n, w in want.items()}
            else:
                j, t = np.asarray(jlosses), np.asarray(tlosses)
                out["more_epochs"] = {"jax": [round(float(x), 5) for x in j],
                                      "port": [round(float(x), 5) for x in t],
                                      "rel_gap": [float(f"{g:.3g}") for g in np.abs(t - j) / j]}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", choices=("seed", "nudge", "bisect"))
    p.add_argument("seed", nargs="?", type=int, default=47)
    p.add_argument("--epochs", type=int)
    p.add_argument("--dtype", default=None)
    p.add_argument("--epoch", type=int, default=74)
    p.add_argument("--more", type=int, default=16)
    a = p.parse_args()
    torch.set_num_threads(1)
    t0 = time.time()
    if a.run == "seed":
        row = seed_run(a.seed, a.epochs or 300, a.dtype or "bfloat16")
    elif a.run == "nudge":
        row = nudge_run(a.epochs or 120, a.dtype or "float32")
    else:
        row = bisect_run(a.epoch, a.more, a.dtype or "float32")
    row["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
