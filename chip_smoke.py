"""The port's full-width run on one GPU, for three jobs: it builds the
kernels, times them for the kernel table (``PERF.md`` section 6), and
drives every path of the port at full width through them, each held to
its plain-version or one-process counterpart. Each kernel timed is also
held to the plain version timed beside it, on the same outputs, and two
of its launches to the same bits; the ``cuda`` tests (``python -m pytest
tests/ -m cuda`` on the card, ``tests/test_torch_cuda.py``) hold the
kernels at their edge shapes, in every layout and against each other. The
port's speed is the benchmark's (``benchmark/run.py``).

    python3 chip_smoke.py

Phases, one JSON line each, each with its own seconds (``seconds``, which
budgets the script against its time limit and measures no path):

- device; build (the four kernel sources by nvcc and the host CSV parser,
  started together; each library's tensor-core instructions counted in
  its SASS: K1/K2 must have some);
- the kernel table: K1 (BiLSTM recurrence) and K2 (its adjoint) per step
  at B=1, 32 and 128, K2 also in both of its tilings from B=32 to 256; K3
  (CTC forward) loss only at B=128 and with the alpha store at B=32; K4
  (its adjoint); K5a/K5b (one direction) at B=32 and 128 and at the
  shapes the family meshes give them; K6a/K6b (the batch-major scan);
  later the fusion kernels (K1/K2 at H=100, K3/K4 at K=22, N=35) and the
  rgb kernels (K1/K2 at H=512, B=8 and 256, K3/K4 at K=22, N=28). Each
  beside its plain version, whose outputs it must match within the
  tolerances below (and ``torch.nn.functional.ctc_loss`` for K3/K4), and
  its least time on this card from ``benchmark/roofline.py`` (the CTC
  bounds from the lattice states the labels visit); K2's two tilings give
  the same dz bits;
- the batch-major layer API (a train-mode ``bilstm_layer`` stack and an
  ``lstm_layer`` at the speech encoder's width, forward and backward,
  against K1 and the plain versions);
- the serving slice (decode -> MLF -> evaluate -> eval loss -> B=1 infer;
  logits and loss against the plain path);
- the training slice (``fit`` at full speech width, a train step through
  the kernels against the same step through the plain versions, a
  learning check);
- the fit path (``fit``'s host and device-resident data paths,
  bit-identical; synchronous and asynchronous checkpoints, the slots'
  bytes equal; ``sync_every=2``; then ``train speech --cache-dir
  --trace-dir --async-checkpoints`` through the CLI, the trace holding
  K1-K4, a decode of a msgpack slot written in the JAX package's layout
  against the ``.pt`` slot's MLF, and ``--debug-nans`` raising on a
  corpus with NaNs);
- the synthetic slice (the C++ CSV reader bit for bit against libc's
  ``strtof`` on decimals beside float32 rounding midpoints; the ported
  example ``python -m mgr_tpu_torch.examples.synthetic_end_to_end`` at its
  defaults for 2 epochs; a learning run on the example's corpus with noise
  and dropout 0 that must decode its train split to an accuracy of at
  least 0.9; a synthetic speech corpus of 80 CSVs through ``train
  speech``, ``decode speech`` and ``score`` at full width);
- the examples slice (the four learning drivers of
  ``mgr_tpu_torch/examples`` at full width for 2 epochs on a few files;
  each JSON row's keys and finite losses, K1-K4 counted per run);
- the fusion slice (early fusion trained by ``fit`` and decoded; speech
  and skeletal donors trained, grafted into late fusion, ``fit`` over the
  frozen encoders, decode and evaluate; each family's step launches, its
  kernel step against the plain one, a learning check);
- the rgb slice (40 seeded videos on disk, ``fit`` with remat, decode to
  MLF, evaluate, B=1 ``infer rgb``; the step's launches and peak memory,
  its kernel step against the plain one, a learning check);
- the prepare slice (seeded raw recordings at the reference's sizes:
  ``prepare-audio``, ``prepare-skeletal --split-at``, ``prepare-rgb`` and
  ``mix`` through the CLI; each featurizer's card output against its CPU
  output; ``train speech`` and ``decode speech`` on the prepared corpus);
- the mesh slice (a mesh train and eval step at full speech width on 2x1,
  1x2 and 2x2 meshes of gloo ranks that time-share the one card, against
  the single-process step, and ``fit`` over the 2x2 mesh);
- the mesh slice of every family (early fusion, late fusion and rgb on
  2x2 and rgb on 2x1 against the single-process step, speech and late
  fusion decoded over both meshes, ``run_curriculum`` over 2x1);
- the GSPMD slice (speech with noise and dropout on over 1x4, 2x1x2 and
  1x2x2 meshes of gloo ranks sharing the card, one train step each
  against the single-process step with the same draws, its launches and
  all-reduces; the other families one step each on 1x4 with their
  encoders at depth 1; ``fit`` over 1x2x2, its slot decoded bit for bit
  as the ranks' parameters);
- the bench (``mgr_tpu_torch.bench`` at the JAX bench's defaults for
  every pipeline, speech's ``--latency`` and the CLI's ``bench`` in a
  subprocess: each line has the JAX line's keys and positive rates, its
  launches those of its steps);
- the dryrun (``entry.dryrun_multichip(8)`` and ``(2)`` on gloo ranks
  sharing the card, each rank 0's launches its route's kernels);

then a JSON line of the kernel table (each kernel's times and bounds and
its launches on every path) and last ``{"ok": true, "device":
{"platform": "gpu", ...}}``. Any failed phase or rank raises, so the exit
code is not 0 and the last line is never printed. There is no CPU
fallback: without a CUDA device the script fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# The port must need neither JAX nor the JAX package: make any import of
# them fail loudly.
for _name in ("jax", "flax", "msgpack", "pandas", "mgr_tpu"):
    sys.modules[_name] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.roofline import ctc_bound, ctc_visits, lstm_bound  # noqa: E402

SEED = 0
KERNELS = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd", "lstm_tm_fwd", "lstm_tm_bwd",
           "lstm_scan_fwd", "lstm_scan_bwd")
B_K1, T_K1, H_K1 = 128, 1900, 500          # speech encoder shapes
B_K2 = 32                                   # the preset's train batch
B_STEP = (1, 32, 128)  # K1/K2 per-step cost: B=1 is the floor (barrier + latency)
B_TILINGS = (32, 64, 96, 128, 256)  # K1, K2 timed in both tilings (one and two batch groups)
B_K3, T_K3, K_K3, N_K3 = 128, 1898, 44, 150  # speech CTC shapes (T - trim)
B_K4 = 32
TOL_K1_H = 3e-2        # max |h| diff: bf16 h stream, f32 sums in another order
TOL_K2_REL = 2e-2      # max |dz| diff / max |dz|, and dU relative Frobenius:
                       # bf16 dz, recomputed z, f32 sums in another order, T steps
TOL_K3_REL = 1e-4      # |loss| and |alpha| diff relative to max(1, |.|): f32 lse chain
TOL_K4 = 1e-3          # max |d log_probs| diff: occupancies in [-1, 0], f32 exp
                       # chains over 1898 steps
TOL_FRAME_SUM = 5e-2   # |sum_k d lp[t] + 1|: the f32 alphas reach -7e3 at t=1898, where
                       # one ulp is 5e-4, and y_pre = alpha - lp read back from them
                       # carries it into every step's weights (the JAX kernel's algorithm)
TOL_LOGITS = 3e-2      # slice logits, kernel path vs plain path (bf16 model)
TOL_LOSS_REL = 1e-3    # slice mean eval loss / train loss, kernel path vs plain path
TOL_GRAD_REL = 5e-2    # train-step gradients, kernel path vs plain path, relative
                       # Frobenius per parameter (bf16 model, 1900 recurrent steps)
N_FILES, B_SLICE = 128, 32  # 4 batches at the preset's batch size
N_TRAIN, N_VAL, EPOCHS = 64, 32, 3  # the training slice: 2 train + 1 val batch per epoch
LEARN_STEPS = 10
FIT_EPOCHS = 2         # fit_path: 2 epochs of the training slice's 64 + 32 files a run
N_CLI_FILES = 80       # `train speech` on disk: the 80/20 split gives 2 train batches of 32
N_NAN_FILES = 5        # `train --debug-nans` at B=2: 2 train batches, every file holds a NaN
FIT_KERNELS = {"bilstm_tm_fwd": "lstm_fwd_kernel", "bilstm_tm_bwd": "lstm_bwd_kernel",
               "ctc_fwd": "ctc_fwd_kernel", "ctc_bwd": "ctc_bwd_kernel"}
B_K5 = (32, 128)       # K5 at the preset's batch (a 1x2 mesh rank) and at B=128
K5_FAM_SHAPES = ((4, 512), (16, 100), (16, 500), (16, 300))  # (rows a rank, H) of K5
                       # on 2x2: rgb, the fusion layer, early fusion and the speech
                       # encoder, the skeletal encoder
B_K6 = (32, 128)       # K6 of both directions at T=1900, H=500
MESHES = ((2, 1), (1, 2), (2, 2))  # (data, model): DP only, TP only, DP x TP
N_MESH_TRAIN, N_MESH_VAL = 64, 32  # fit over the 2x2 mesh: 2 train + 1 val batch
MESH_TIMEOUT_S = 420   # per mesh run, ranks started to ranks joined
# The mesh_families phase: every family trained on a 2x2 mesh (rgb on 2x1
# too), speech and late fusion decoded over both, and the curriculum on 2x1;
# the data axis is 2 on both, so a rank holds half of every batch.
FAM_MESHES = ((2, 2), (2, 1))
FAM_TRAIN = {(2, 2): ("early_fusion", "late_fusion", "rgb"), (2, 1): ("rgb",)}
FAM_DECODE = {"speech": 128, "late_fusion": 32}  # global B of each mesh decode
FAM_SEED = {"early_fusion": 40, "late_fusion": 41, "rgb": 42, "speech": 43}
# The gspmd phase: speech at full width with noise and dropout on (one key),
# global B=8, on the GSPMD route's meshes (data, model, time): H-blocks of
# 125 (1x4), time slices of 950 with K1/K2 on every rank (2x1x2), H over 2
# and time (1x2x2, not the direction-sharded route); one train step each,
# held against one process. The other families one step each on 1x4 at
# global B=2 (rgb's H=512 in blocks of 128), their encoders cut to depth 1:
# gloo's all-reduce over 4 ranks takes ~6 ms on the one-card machine, and a
# step of depth 2 makes 7,600 of them. fit over 1x2x2 on 8 + 8 files (1
# train + 1 val batch).
GSPMD_MESHES = ((1, 4, 1), (2, 1, 2), (1, 2, 2))
GSPMD_B, GSPMD_FAM_B = 8, 2
GSPMD_FAM_MESH, GSPMD_FIT_MESH = (1, 4, 1), (1, 2, 2)
GSPMD_FAM_DEPTH = 1
N_GSPMD_TRAIN, N_GSPMD_VAL = 8, 8
GSPMD_TIMEOUT_S = 600  # per mesh run, ranks started to ranks joined
N_FUS_TRAIN, N_FUS_VAL, FUS_EPOCHS = 64, 32, 2  # the fusion slice: 2 train + 1 val batch
H_FUS = 100            # the late-fusion BiLSTM over the 1600-wide encoder concat
K_FUS, N_FUS = 22, 35  # the fusion presets' gesture classes and label cap
H_RGB, B_RGB = 512, 8  # the rgb preset's BiLSTM width (MAX_H) and train batch
B_RGB_EDGE = 256       # K2's largest launch: 230,400 bytes of shared memory at H=512
K_RGB, N_RGB = 22, 28  # the rgb preset's gesture classes and label cap
N_RGB_FILES, RGB_EPOCHS = 40, 2  # the rgb slice: the 80/20 split gives 4 train + 1 val batch
# The prepare slice, at the reference's sizes: 95 s WAVs (9,498 MFCC frames,
# T=1900 after the speech preset's x5), 1,900-frame Kinect CSVs and 480x640
# videos; only the file counts are cut. Ids below PREP_SPLIT_AT are train.
PREP_TRAIN_IDS, PREP_VAL_IDS, PREP_SPLIT_AT = (1, 2, 3, 4), (403, 404, 405, 406), 403
PREP_VIDEO_IDS = (1, 2)
PREP_WAV_S, PREP_RATE, PREP_FRAMES = 95, 16000, 1900
PREP_MOVED = 2         # mix: val files moved into train
PREP_BATCH = 2         # the speech fit on 8 files: the 80/20 split gives 3 train + 1 val batch
TOL_MFCC_RTOL, TOL_MFCC_ATOL = 1e-4, 1e-3  # card vs CPU: cuFFT against the CPU's FFT
TOL_KIN = 1e-5         # kinematics' non-integer columns (atan2); integer columns exact
TOL_ROI = 1e-3         # ROI crops on the 0-255 scale (f32 products in another order)
# The synthetic slice: the example's corpus and widths (B=2, T=64, BiLSTM(16)x2)
# with input noise and dropout 0, trained until it decodes its train split
# (the JAX package reaches accuracy 1.0 at 1000 epochs in f32 on the CPU);
# the speech corpus read by the CSV reader and by np.loadtxt (80 files, ~36 MB).
SYN_LEARN_EPOCHS = 1000
SYN_MIN_ACCURACY = 0.9
SYN_MID_ROWS = 5000    # the reader's file: 5,000 rows x 39 values beside f32 midpoints
SYN_AUDIO = dict(n_files=80, frames_per_label=600, max_labels=3, seed=0)
# The examples phase: the four learning drivers at full width and T=1900
# (hidden scale 1), 2 epochs on a few files each, through the paths of the
# JAX package's toy environments: the convergence and generalization checks'
# late-fusion stage (pretrains, graft, frozen head; the convergence check's
# anneal leg with unfrozen encoders), the measured curriculum with its
# accuracy probes and the finetune leg forced by an impossible late-fusion
# target, and the A/B's biased arm through ``python -m`` in a subprocess.
# Also the convergence check's early-fusion and rgb stages at their
# corpora's longest content (4 gestures of 24 skeletal frames, or of 16
# video frames), full width. A run's driver is the name before the colon.
EXAMPLES_ENV = {
    "convergence_check": {
        "MGR_TPU_CONV_ONLY": "late_fusion", "MGR_TPU_CONV_FILES": "10",
        "MGR_TPU_CONV_EPOCHS": "2", "MGR_TPU_CONV_PRETRAIN": "2", "MGR_TPU_CONV_BATCH": "4",
        "MGR_TPU_CONV_FUSION_FPL": "90", "MGR_TPU_CONV_FUSION_LABELS": "4",
        "MGR_TPU_CONV_LR2": "1e-3", "MGR_TPU_CONV_EPOCHS2": "1", "MGR_TPU_CONV_FINETUNE": "1",
        "MGR_TPU_CONV_GUARD": "1", "MGR_TPU_CONV_PLATEAU": "0.5:2:1e-4:1e-3",
        "MGR_TPU_CONV_BLANK_BIAS": "-3"},
    "convergence_check:early_fusion": {
        "MGR_TPU_CONV_ONLY": "early_fusion", "MGR_TPU_CONV_FILES": "10",
        "MGR_TPU_CONV_EPOCHS": "2", "MGR_TPU_CONV_MAXLEN": "96", "MGR_TPU_CONV_BATCH": "4"},
    "convergence_check:rgb": {
        "MGR_TPU_CONV_ONLY": "rgb", "MGR_TPU_CONV_RGB_FILES": "10",
        "MGR_TPU_CONV_EPOCHS": "2", "MGR_TPU_CONV_RGB_MAXLEN": "64",
        "MGR_TPU_CONV_RGB_BATCH": "4"},
    "generalization_check": {
        "MGR_TPU_GEN_ONLY": "late_fusion", "MGR_TPU_GEN_FILES": "10",
        "MGR_TPU_GEN_EPOCHS": "2", "MGR_TPU_GEN_BATCH": "4", "MGR_TPU_GEN_FUSION_BATCH": "2",
        "MGR_TPU_GEN_FPL": "90", "MGR_TPU_GEN_LABELS": "4", "MGR_TPU_GEN_SYNC": "1",
        "MGR_TPU_GEN_PATIENCE": "2", "MGR_TPU_GEN_RLR": "late_fusion:0.5/1/1e-5"},
    "curriculum_bench": {
        "MGR_TPU_CB_MEASURED": "1", "MGR_TPU_CB_NTRAIN": "8", "MGR_TPU_CB_NVAL": "4",
        "MGR_TPU_CB_EPOCHS": "2", "MGR_TPU_CB_BATCH": "4",
        "MGR_TPU_CB_ACC_TARGET": "speech:0.0,late_fusion:2.0", "MGR_TPU_CB_ACC_EVERY": "1",
        "MGR_TPU_CB_BLANK_BIAS": "-3", "MGR_TPU_CB_FINETUNE_EPOCHS": "1"},
    "skeletal_bias_ab": {
        "MGR_TPU_AB_FILES": "10", "MGR_TPU_AB_MAXLEN": "1900", "MGR_TPU_AB_SCALE": "1",
        "MGR_TPU_AB_BATCH": "4", "MGR_TPU_AB_EPOCHS1": "2", "MGR_TPU_AB_EPOCHS2": "1"},
}
EXAMPLES_TIMEOUT_S = 300  # the A/B's subprocess
# The bench phase: every pipeline at its bench defaults (full width, T=1900,
# the JAX bench's default batch), then speech's B=1 latency, then the speech
# bench as users start it (the CLI in a subprocess); the dryrun phase's rank
# counts (2x2x2: the GSPMD route in phase 1; 1x2x1: direction-sharded).
BENCH_PIPELINES = ("speech", "skeletal", "rgb", "early_fusion", "late_fusion")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "spread",
              "decode_seqs_per_sec_per_chip", "decode_spread", "pipeline", "batch"}
LATENCY_KEYS = {"metric", "value", "unit", "vs_baseline", "spread", "pipeline", "batch"}
BENCH_CLI_TIMEOUT_S = 300
DRYRUN_RANKS = (8, 2)

_since = [time.perf_counter()]  # when the last phase line was printed


def phase(name: str, **fields) -> None:
    """A phase's JSON line, with the seconds since the last one: its own
    time when ``main`` runs the phases in turn, which budgets the script
    against its time limit and measures no path."""
    now = time.perf_counter()
    print(json.dumps({"phase": name, **fields, "seconds": now - _since[0]}), flush=True)
    _since[0] = now


def cuda_time_ms(fn, reps: int) -> float:
    """ms a call of ``fn``: CUDA events around ``reps`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(fn):
    """fn()'s result and its time in ms (CUDA events around one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _tensors(out) -> tuple:
    return out if isinstance(out, (tuple, list)) else (out,)


def _timing(kernel, plain, lim: dict, what: str, check, reps: int = 5) -> dict:
    """A kernel's ms a launch beside its plain version's (one call) and its
    least time on this card (``benchmark/roofline.py``), and the share of
    that least time the kernel reaches. The outputs timed are held to each
    other: ``check(what, got, want)`` returns the errors it read and raises
    past a tolerance; a second launch must give the first one's bits. The
    kernel's first call, the one checked, pays its first-call costs before
    the timed ones."""
    got = kernel()
    ms = cuda_time_ms(kernel, reps)
    want, plain_ms = _timed(plain)
    errors = check(what, got, want)
    if not all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(kernel()))):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    return {"ms": ms, "plain_ms": plain_ms, **lim, "share": lim["bound_ms"] / ms, **errors}


def _held(what: str, got, errors: dict, tol: float) -> dict:
    """``errors``, once every output in ``got`` is finite and every error
    within ``tol``; else raises."""
    if not all(torch.isfinite(g.float()).all() for g in _tensors(got)) or \
            not max(errors.values()) <= tol:
        raise AssertionError(f"{what} disagrees with its plain version: {errors} (tol {tol})")
    return {**errors, "tol": tol}


def _streams_check(what: str, got, want) -> dict:
    """K1/K5a/K6a: each stored stream (h, and c) within TOL_K1_H."""
    return _held(what, got, {"max_abs_err_h_c": max(
        float((g.float() - w.float()).abs().max())
        for g, w in zip(_tensors(got), _tensors(want)))}, TOL_K1_H)


def _dz_check(what: str, dz, dz_want, dU, dU_want, *, fro: bool) -> dict:
    """K2/K5b/K6b: each dz within TOL_K2_REL of its largest |dz| (with
    ``fro`` in relative Frobenius norm: a recomputed z within an ulp of
    +-2.5 gets the hard sigmoid's slope 0.2 on one side and 0 on the
    other, which moves that one dz entry by its own size), and dU in
    relative Frobenius norm."""
    def rel(g, w):
        d, w = g.float() - w.float(), w.float()
        return float(d.norm() / w.norm()) if fro else float(d.abs().max() / w.abs().max())
    errors = {"dz_fro_rel" if fro else "dz_max_rel": max(rel(g, w) for g, w in zip(dz, dz_want)),
              "dU_fro_rel": float((dU - dU_want).norm() / dU_want.norm())}
    return _held(what, dz, errors, TOL_K2_REL)


def _ctc_fwd_check(what: str, got, want) -> dict:
    """K3: the loss (and the stored alphas) relative to max(1, |.|)."""
    return _held(what, got, {"max_rel_err": max(
        float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
        for g, w in zip(_tensors(got), _tensors(want)))}, TOL_K3_REL)


def _ctc_bwd_check(in_len):
    """K4: d log_probs within TOL_K4, zero past each length, and each valid
    frame's gradient summing to -1 within TOL_FRAME_SUM (the occupancies of
    a frame sum to 1; the seeds are the loss's)."""
    def check(what, got, want):
        valid = torch.arange(got.shape[0], device=got.device)[:, None] < in_len[None, :]
        frame_sum = float((got.sum(-1)[valid] + 1.0).abs().max())
        errors = _held(what, got, {"max_abs_err": float((got - want).abs().max())}, TOL_K4)
        if frame_sum > TOL_FRAME_SUM or not bool((got[~valid] == 0).all()):
            raise AssertionError(f"{what}: frame sums off by {frame_sum} (tol {TOL_FRAME_SUM}) "
                                 "or a nonzero gradient past a length")
        return {**errors, "frame_sum_err": frame_sum, "tol_frame_sum": TOL_FRAME_SUM}
    return check


def library_ctc_ms(lp, labels, in_len, lab_len, blank, *, backward: bool) -> float:
    """Time of torch.nn.functional.ctc_loss, the one PyTorch call that
    computes a CTC loss (forward), or of its backward, on the same inputs:
    a yardstick only, the port never calls it (its lattice has no skip
    penalty, so its values differ slightly from the reference's)."""
    targets, il, tl = labels.clamp_min(0).long(), in_len.long(), lab_len.long()
    if not backward:
        return cuda_time_ms(lambda: torch.nn.functional.ctc_loss(
            lp, targets, il, tl, blank=blank, reduction="none"), reps=20)
    x = lp.detach().requires_grad_()
    loss = torch.nn.functional.ctc_loss(x, targets, il, tl, blank=blank, reduction="sum")
    return cuda_time_ms(lambda: torch.autograd.grad(loss, x, retain_graph=True), reps=20)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU fallback here")
    print(_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    phase("device", kind=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    return name


def build_phase() -> None:
    """Builds the kernels (one nvcc per source) and the host CSV parser
    (the host C++ compiler), all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mgr_tpu_torch.kernels import build

    from mgr_tpu_torch.ops import dispatch

    sources = sorted({dispatch.SOURCES[name] for name in KERNELS})
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(build.load_host, "fastcsv")
        build.load_all(sources)  # one nvcc per source, all started together
        host.result()
    ptxas = {
        name: [ln.strip() for ln in build.build_log(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in sources
    }
    # Tensor-core instructions in each library's SASS: the recurrences'
    # step products must show HMMA (mma.sync) or HGMMA (wgmma).
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = {}
    for name in sources:
        out = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                             capture_output=True, text=True, timeout=120, check=True).stdout
        sass[name] = {op: sum(1 for ln in out.splitlines() if f" {op}." in ln or f" {op} " in ln)
                      for op in ("HMMA", "HGMMA")}
    for name in ("bilstm_tm_fwd", "bilstm_tm_bwd"):
        if sass[name]["HMMA"] + sass[name]["HGMMA"] == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in its SASS: {sass[name]}")
    phase("build", ptxas=ptxas, sass_tensor_core_instructions=sass)


def _lstm_inputs(dev, lead, H, dirs=2):
    """Seeded bf16 inputs of a recurrence launch, made on the card: the
    projections (dirs, *lead, 4, H) with a unit forget bias, as after the
    projection, U (dirs, H, 4, H) and the cotangents of h (dirs, *lead, H).
    ``lead`` is (T, B) for the time-major kernels, (B, T) for K6."""
    from mgr_tpu_torch.ops.lstm import init_bilstm_params

    gen = torch.Generator(dev).manual_seed(SEED)
    xp = 0.5 * torch.randn((dirs, *lead, 4, H), generator=gen, device=dev)
    xp[..., 1, :] += 1.0
    U = init_bilstm_params(torch.Generator().manual_seed(SEED), 8, H)["U"][:dirs]
    dhs = 1e-2 * torch.randn((dirs, *lead, H), generator=gen, device=dev)
    bf = torch.bfloat16
    return xp.to(bf), U.to(dev, bf), dhs.to(bf)


def _tilings(run, what: str) -> dict:
    """``run(B)``, a launch at B rows (T=1900, H=500) through its wrapper,
    at B_TILINGS in both tilings (one and two batch groups, each forced
    through the wrappers' rule): ms a launch and a step, and the rule's
    choice. The two tilings' outputs must be the same bits: the numbers
    behind ``bilstm_tm.GROUPED_MIN_B``."""
    from mgr_tpu_torch.kernels import bilstm_tm as kmod

    tilings, rule = {}, kmod.batch_groups
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    try:
        for B in B_TILINGS:
            fn = run(B)
            row, out = {"rule": rule(B, H_K1, sms)}, {}
            tilings[f"B={B}"] = row
            for g in (1, 2):
                kmod.batch_groups = lambda *a, g=g, **k: g
                out[g] = fn()
                ms = cuda_time_ms(fn, reps=3)
                row[f"groups={g}"] = {"ms": ms, "ms_per_step": ms / T_K1}
            if not all(torch.equal(a, b) for a, b in zip(out[1], out[2])):
                raise AssertionError(f"{what}: the two tilings give other bits at B={B}")
    finally:
        kmod.batch_groups = rule
    return tilings


def k1_phase(dev) -> dict:
    """K1 at T=1900, H=500, timed and checked beside its plain version at
    B_STEP (B=1: the per-step floor of barrier and latency; the train
    batch; B=128); then in both tilings at B_TILINGS, their h and c bit
    for bit the same."""
    from mgr_tpu_torch.kernels.bilstm_tm import bilstm_tm, bilstm_tm_streams
    from mgr_tpu_torch.ops.lstm import bilstm_scan_tm_plain

    per_b = {}
    for B in B_STEP:
        xp, U, _ = _lstm_inputs(dev, (T_K1, B), H_K1)
        per_b[f"B={B}"] = t = _timing(
            lambda: bilstm_tm(xp[0], xp[1], U), lambda: bilstm_scan_tm_plain(xp[0], xp[1], U),
            lstm_bound(T_K1, B, H_K1, dirs=2, backward=False, store_c=False),
            f"K1 at B={B}", _streams_check)
        t["ms_per_step"] = t["ms"] / T_K1

    def run(B):
        xp, U, _ = _lstm_inputs(dev, (T_K1, B), H_K1)
        return lambda: bilstm_tm_streams(xp[0], xp[1], U, store_c=True)

    out = {**per_b[f"B={B_K1}"], "library_ms": None, "per_B": per_b}
    phase("k1_bilstm_tm_fwd", T=T_K1, H=H_K1, **out, tilings=_tilings(run, "K1"),
          tilings_give_the_same_bits=True)
    return out


def k3_phase(dev) -> dict:
    """K3 at T'=1898, K=44, N=150: loss only at B=128, timed and checked
    beside its plain version, and beside ``ctc_loss``; and with the alpha
    store at the train batch (B=32), the launch the train path makes."""
    from mgr_tpu_torch.kernels.ctc import NAME, ctc_alpha_loss, launch_shape
    from mgr_tpu_torch.ops.ctc import ctc_alpha_loss_plain

    blank = K_K3 - 1
    lp, args, visits = _ctc_inputs(dev, B_K3, K_K3, N_K3, SEED + 1)
    out = {**_timing(lambda: ctc_alpha_loss(lp, *args, blank),
                     lambda: ctc_alpha_loss_plain(lp, *args, blank),
                     ctc_bound(T_K3, B_K3, K_K3, N_K3, visits, backward=False),
                     "K3", _ctc_fwd_check, reps=20),
           "library_ms": library_ctc_ms(lp, *args, blank, backward=False)}
    store = _ctc_at_shape(dev, SEED + 6, B_K4, K_K3, N_K3)["ctc_fwd"]
    phase("k3_ctc_fwd", B=B_K3, T=T_K3, K=K_K3, N=N_K3, launch=launch_shape(NAME, N_K3, K_K3),
          **out, with_alpha_store={"B": B_K4, **store})
    return out


def k2_phase(dev) -> dict:
    """K2 at T=1900, H=500, timed and checked beside its plain version at
    B_STEP; then in both tilings at B_TILINGS, their dz bit for bit the
    same."""
    from mgr_tpu_torch.kernels import bilstm_tm as k2mod
    from mgr_tpu_torch.ops.lstm import bilstm_scan_tm_bwd_plain, recurrent_weight_grad

    def inputs(B):
        xp, U, dhs = _lstm_inputs(dev, (T_K1, B), H_K1)
        streams = k2mod.bilstm_tm_streams(xp[0], xp[1], U, store_c=True)
        return (xp[0], xp[1], U, *streams, dhs[0], dhs[1])

    per_b = {}
    for B in B_STEP:
        args = inputs(B)
        per_b[f"B={B}"] = t = _timing(
            lambda: k2mod.bilstm_tm_bwd(*args), lambda: bilstm_scan_tm_bwd_plain(*args),
            lstm_bound(T_K1, B, H_K1, dirs=2, backward=True, store_c=False), f"K2 at B={B}",
            lambda what, got, want: _dz_check(
                what, got, want[:2], recurrent_weight_grad(args[3], args[4], *got),
                want[2], fro=False))
        t["ms_per_step"] = t["ms"] / T_K1
    def run(B):
        args = inputs(B)
        return lambda: k2mod.bilstm_tm_bwd(*args)

    out = {**per_b[f"B={B_K2}"], "library_ms": None, "per_B": per_b}
    phase("k2_bilstm_tm_bwd", T=T_K1, H=H_K1, **out, tilings=_tilings(run, "K2"),
          tilings_give_the_same_dz_bits=True)
    return out


def _ctc_batch(rng, B, T, K, N):
    """Labels with L=0, L=N and runs of repeated labels; input lengths
    below T on most rows."""
    blank = K - 1
    lab_len = rng.integers(1, N + 1, size=B)
    lab_len[0], lab_len[1], lab_len[2] = 0, N, 1  # all-blank, full, single
    in_len = rng.integers(2 * N + 2, T + 1, size=B)
    in_len[1] = T
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        seq = rng.integers(0, blank, size=lab_len[b])
        if b % 3 == 0 and lab_len[b] > 1:  # runs of repeated labels
            seq[1::2] = seq[0::2][: len(seq[1::2])]
        labels[b, : lab_len[b]] = seq
    return labels, in_len.astype(np.int32), lab_len.astype(np.int32)


def _ctc_inputs(dev, B, K, N, seed):
    """Seeded log-probs (T', B, K) and ``_ctc_batch``'s labels and lengths
    on the card, and the lattice states the recursion visits for them."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T_K3, B, K), dtype=np.float32)).to(dev), dim=-1)
    labels, in_len, lab_len = _ctc_batch(rng, B, T_K3, K, N)
    args = [torch.from_numpy(a).to(dev) for a in (labels, in_len, lab_len)]
    return lp, args, ctc_visits(in_len, lab_len)


@functools.cache  # k3_phase and k4_phase share the speech shape's launches
def _ctc_at_shape(dev, seed, B, K, N) -> dict:
    """K3 with its alpha store and K4 at T'=1898, B rows, K classes and N
    labels, K4 on K3's alphas as the train path hands them over
    (row-pitched: no layout copy in front of the launch), seeded as the
    loss seeds it: each timed and checked beside its plain version, and
    beside ``ctc_loss``."""
    from mgr_tpu_torch.kernels.ctc import (
        BWD_NAME, NAME, ctc_alpha_bwd, ctc_alpha_loss, launch_shape)
    from mgr_tpu_torch.ops.ctc import ctc_alpha_bwd_plain, ctc_alpha_loss_plain

    lp, args, visits = _ctc_inputs(dev, B, K, N, seed)
    blank = K - 1
    loss, a_phi, a_emit = ctc_alpha_loss(lp, *args, blank, store_alphas=True)
    rows, L = torch.arange(B, device=dev), args[2].long()
    g_phi = -torch.exp(a_phi[-1][rows, L] + loss)
    g_emit = torch.where(L > 0, -torch.exp(a_emit[-1][rows, (L - 1).clamp_min(0)] + loss), 0.0)
    bwd = (lp, *args, blank, a_phi, a_emit, g_phi, g_emit)
    return {
        "ctc_fwd": {
            **_timing(lambda: ctc_alpha_loss(lp, *args, blank, store_alphas=True),
                      lambda: ctc_alpha_loss_plain(lp, *args, blank, store_alphas=True),
                      ctc_bound(T_K3, B, K, N, visits, backward=False, store=True),
                      f"K3 at K={K}, N={N}", _ctc_fwd_check, reps=20),
            "launch": launch_shape(NAME, N, K),
            "library_ms": library_ctc_ms(lp, *args, blank, backward=False)},
        "ctc_bwd": {
            **_timing(lambda: ctc_alpha_bwd(*bwd), lambda: ctc_alpha_bwd_plain(*bwd),
                      ctc_bound(T_K3, B, K, N, visits, backward=True),
                      f"K4 at K={K}, N={N}", _ctc_bwd_check(args[1]), reps=20),
            "launch": launch_shape(BWD_NAME, N, K),
            "library_ms": library_ctc_ms(lp, *args, blank, backward=True)},
    }


def k4_phase(dev) -> dict:
    """K4 at B=32, T'=1898, K=44, N=150 (``_ctc_at_shape``)."""
    out = _ctc_at_shape(dev, SEED + 6, B_K4, K_K3, N_K3)["ctc_bwd"]
    phase("k4_ctc_bwd", B=B_K4, T=T_K3, K=K_K3, N=N_K3, **out)
    return out


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls, forward and backward, to the plain
    versions, for the comparison only (the package itself has no such
    switch)."""
    from mgr_tpu_torch.kernels import bilstm_tm as k1, ctc as k3, lstm_scan as k6
    from mgr_tpu_torch.ops.ctc import ctc_alpha_bwd_plain, ctc_alpha_loss_plain
    from mgr_tpu_torch.ops.lstm import (
        bilstm_scan_tm_bwd_plain, bilstm_scan_tm_plain, recurrent_scan_bwd_plain,
        recurrent_scan_plain)

    saved = (k1.bilstm_tm_streams, k1.bilstm_tm_bwd, k3.ctc_alpha_loss, k3.ctc_alpha_bwd,
             k6.lstm_scan_streams, k6.lstm_scan_bwd)
    k1.bilstm_tm_streams = lambda xp0, xp1, U, store_c=False: bilstm_scan_tm_plain(
        xp0, xp1, U, store_c=store_c, out_dtype=torch.bfloat16)
    k1.bilstm_tm_bwd = lambda *a: bilstm_scan_tm_bwd_plain(*a)[:2]
    k3.ctc_alpha_loss = ctc_alpha_loss_plain
    k3.ctc_alpha_bwd = ctc_alpha_bwd_plain
    k6.lstm_scan_streams = lambda xp, U, store_c=False: recurrent_scan_plain(
        xp, U, store_c=store_c, out_dtype=torch.bfloat16)
    k6.lstm_scan_bwd = recurrent_scan_bwd_plain
    try:
        yield
    finally:
        (k1.bilstm_tm_streams, k1.bilstm_tm_bwd, k3.ctc_alpha_loss, k3.ctc_alpha_bwd,
         k6.lstm_scan_streams, k6.lstm_scan_bwd) = saved


def slice_phase(dev) -> dict:
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.data.batcher import Batcher, pad_or_truncate
    from mgr_tpu_torch.decode.decoder import MLF_FILENAMES, Decoder
    from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
    from mgr_tpu_torch.decode.mlf import read_mlf
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train.step import make_eval_step

    cfg = get_preset("speech")
    T, F, trim = cfg.maxlen, cfg.num_feats, cfg.ctc.trim_frames
    model = build_model(cfg, seed=SEED, device=dev)

    rng = np.random.default_rng(SEED + 2)
    feats = rng.standard_normal((N_FILES, T, F), dtype=np.float32)
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=N_FILES).astype(np.int32)
    labels = np.full((N_FILES, cfg.max_label_len), -1, np.int32)
    for i, n in enumerate(lab_len):
        labels[i, :n] = rng.integers(0, cfg.nb_classes - 1, size=n)
    in_len = np.full((N_FILES,), T - trim, np.int32)  # padded-length parity
    ids = list(range(1, N_FILES + 1))
    data = Batcher(feats, labels, lab_len, in_len, ids, train_ids=[], val_ids=ids)
    batches = list(data.epoch(cfg.batch_size, train=False))

    dec = Decoder.for_model(model, "speech")
    eval_step = make_eval_step(model)
    dispatch.reset_launch_counts()
    results = dec.decode_batches(batches)
    with tempfile.TemporaryDirectory() as tmp:
        mlf_path = os.path.join(tmp, MLF_FILENAMES["speech"])
        dec.write_mlf(mlf_path, results)
        n_mlf = len(read_mlf(mlf_path))
    metrics = evaluate_accuracy(model, data)
    losses = [float(eval_step(b)) for _, b in batches]
    x1, true_len = pad_or_truncate(feats[0][: T - 300], T)
    one = {"inputs": x1[None], "input_length": np.asarray([true_len - trim], np.int32)}
    tokens = dec.decode_batches([((ids[0],), one)])
    launches = {k: v for k, v in dispatch.launch_counts().items()
                if k in ("bilstm_tm_fwd", "ctc_fwd")}

    if min(launches.values()) <= 0:
        raise AssertionError(f"the serving path skipped a kernel: {launches}")
    if len(results) != N_FILES or n_mlf != N_FILES or len(tokens) != 1:
        raise AssertionError(f"decoded {len(results)} / MLF {n_mlf} of {N_FILES}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite eval loss {losses}")

    # One batch through the kernels and through the plain versions, same card.
    b0 = batches[0][1]
    x = torch.from_numpy(b0["inputs"]).to(dev)
    with torch.inference_mode():
        logits_k = model(x)
        loss_k = float(eval_step(b0))
        with plain_path():
            logits_p = model(x)
            loss_p = float(eval_step(b0))
    d_logits = float((logits_k - logits_p).abs().max())
    d_loss = abs(loss_k - loss_p) / max(1.0, abs(loss_p))
    if logits_k.shape != (B_SLICE, T, cfg.nb_classes) or not torch.isfinite(logits_k).all():
        raise AssertionError(f"bad logits {tuple(logits_k.shape)}")
    if d_logits > TOL_LOGITS or d_loss > TOL_LOSS_REL:
        raise AssertionError(
            f"slice disagrees with the plain path: logits {d_logits} (tol {TOL_LOGITS}), "
            f"loss rel {d_loss} (tol {TOL_LOSS_REL})")

    phase("slice", pipeline="speech", B=B_SLICE, T=T, files=N_FILES,
          launches=launches, mlf_entries=n_mlf,
          accuracy=metrics["accuracy"], eval_loss_mean=float(np.mean(losses)),
          logits_max_abs_err=d_logits, tol_logits=TOL_LOGITS,
          loss_rel_err=d_loss, tol_loss_rel=TOL_LOSS_REL)
    return launches


def _speech_corpus(cfg, n, seed):
    """n files of seeded random features (T, F) and labels (1..N words)."""
    rng = np.random.default_rng(seed)
    T, F = cfg.maxlen, cfg.num_feats
    feats = rng.standard_normal((n, T, F), dtype=np.float32)
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=n).astype(np.int32)
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    in_len = np.full((n,), T - cfg.ctc.trim_frames, np.int32)
    return feats, labels, lab_len, in_len


def train_phase(dev) -> dict:
    """The training slice at the full speech width: fit() for 3 epochs on
    an in-memory corpus (launch counts of all four kernels) and its peak
    card memory, the best slot reloaded and decoded, one train step
    through the kernels against the same step through the plain versions
    (same parameters, same masks), and a learning check."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core import prng
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.data.batcher import Batcher
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.loop import fit

    cfg = get_preset("speech")
    B = cfg.batch_size
    feats, labels, lab_len, in_len = _speech_corpus(cfg, N_TRAIN + N_VAL, SEED + 7)
    ids = list(range(1, N_TRAIN + N_VAL + 1))
    data = Batcher(feats, labels, lab_len, in_len, ids,
                   train_ids=ids[:N_TRAIN], val_ids=ids[N_TRAIN:])
    model = build_model(cfg, seed=SEED, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)  # the peak of this phase alone

    with tempfile.TemporaryDirectory() as workdir:
        dispatch.reset_launch_counts()
        res = fit(model, data, workdir=workdir, epochs=EPOCHS)
        launches = dispatch.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        one_process = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd")
        if min(launches[k] for k in one_process) <= 0 or any(
                v for k, v in launches.items() if k not in one_process):
            raise AssertionError(f"the training path took the wrong kernels: {launches}")
        if res.epochs_run != EPOCHS or not all(
                np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in res.history):
            raise AssertionError(f"fit ran {res.epochs_run} epochs: {res.history}")
        fresh = build_model(cfg, seed=SEED + 99, device=dev)
        ckpt_lib.load_params(workdir, "speech", fresh, slot="best")
        one = next(iter(data.epoch(B, train=False)))
        decoded = Decoder.for_model(fresh, "speech").decode_batches([one])
        if len(decoded) != B:
            raise AssertionError(f"the best slot decoded {len(decoded)} of {B}")

    state = step_lib.create_train_state(model)
    train_step = step_lib.make_train_step(model)
    batch = next(iter(data.epoch(B, train=True, shuffle_seed=0)))[1]
    key = prng.fold_name(prng.root_key(SEED), "dropout")

    # One step through the kernels and through the plain versions, from
    # the same parameters and the same masks (the draws depend on the key).
    check = _kernel_vs_plain_step(model, batch, prng.fold_in(key, 1000), dev)

    # Learning check: a fixed batch's eval loss falls over steps on it.
    eval_step = step_lib.make_eval_step(model)
    before = float(eval_step(batch))
    for i in range(LEARN_STEPS):
        state, m = train_step(state, batch, prng.fold_in(key, 2000 + i))
    after = float(eval_step(batch))
    if not after < before:
        raise AssertionError(f"no learning: eval loss {before} -> {after}")

    phase("train", pipeline="speech", B=B, T=cfg.maxlen, H=cfg.encoder.hidden,
          files_train=N_TRAIN, files_val=N_VAL, epochs=EPOCHS, launches=launches,
          epoch_train_loss=[h["train_loss"] for h in res.history],
          epoch_val_loss=[h["val_loss"] for h in res.history], peak_mem_gb=peak_gb,
          **check, tol_loss_rel=TOL_LOSS_REL, tol_grad_rel=TOL_GRAD_REL,
          learning_check={"eval_loss_before": before, "eval_loss_after": after,
                          "steps": LEARN_STEPS})
    return launches


def _write_audio_corpus(root, feats, labels, nan=False):
    """Per-file audio CSVs (39 features + file_number, the reference's
    layout) and an Id,Sequence label file of gesture classes."""
    from mgr_tpu_torch.data.formats import write_label_csv

    data_dir = os.path.join(root, "audio")
    os.makedirs(data_dir, exist_ok=True)
    header = ",".join(str(i) for i in range(39)) + ",file_number\n"
    row = ",".join(["%.6f"] * 40) + "\n"
    for fid, x in enumerate(feats, 1):
        x = np.concatenate([x, np.full((len(x), 1), fid, np.float32)], axis=1)
        if nan:
            x[5, 0] = np.nan
        with open(os.path.join(data_dir, f"audio_{fid}.csv"), "w") as f:
            f.write(header + (row * len(x)) % tuple(x.ravel().tolist()))
    label_file = os.path.join(root, "labels.csv")
    write_label_csv(label_file, {fid: seq for fid, seq in enumerate(labels, 1)})
    return data_dir, label_file


def _msgpack(x) -> bytes:
    """A small msgpack packer of flax's layout (maps, str, bin, arrays,
    ints; an ndarray as ext 1 of [shape, dtype name, C-order bytes]), to
    write a JAX-format slot on a host without flax."""
    def head(n, fix, fix_max, wide):
        if n <= fix_max:
            return bytes([fix | n])
        for code, width in wide:
            if n < 1 << (8 * width):
                return bytes([code]) + n.to_bytes(width, "big")
        raise ValueError(n)

    if isinstance(x, dict):
        return head(len(x), 0x80, 15, ((0xDE, 2), (0xDF, 4))) + b"".join(
            _msgpack(k) + _msgpack(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return head(len(x), 0x90, 15, ((0xDC, 2), (0xDD, 4))) + b"".join(map(_msgpack, x))
    if isinstance(x, str):
        b = x.encode()
        return head(len(b), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + b
    if isinstance(x, bytes):
        return head(len(x), 0, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + x
    if isinstance(x, int) and x >= 0:
        return head(x, 0, 127, ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)))
    if isinstance(x, np.ndarray):
        payload = _msgpack([list(x.shape), x.dtype.name, np.ascontiguousarray(x).tobytes()])
        return head(len(payload), 0, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4))) + b"\x01" + payload
    raise TypeError(type(x))


def _jax_slot(state_pt: str) -> bytes:
    """The JAX package's TrainState layout of a port ``state.pt``: step,
    params, and optax's chain (clip, scale_by_adam, scale_by_schedule)."""
    from mgr_tpu_torch.bridge import unflatten

    saved = torch.load(state_pt, map_location="cpu", weights_only=True)
    opt = saved["opt_state"]

    def tree(d):
        return unflatten({k: v.numpy() for k, v in d.items()})

    return _msgpack({
        "step": np.asarray(saved["step"], np.int32),
        "params": tree(saved["params"]),
        "opt_state": {"0": {}, "1": {"count": opt["count"].numpy(), "mu": tree(opt["mu"]),
                                     "nu": tree(opt["nu"])},
                      "2": {"count": opt["schedule_count"].numpy()}},
    })


def _trace_kernels(trace_dir):
    """The names of the device kernels in the torch.profiler trace(s)."""
    names = set()
    for f in os.listdir(trace_dir):
        if f.endswith(".pt.trace.json"):
            with open(os.path.join(trace_dir, f)) as fh:
                events = json.load(fh).get("traceEvents", [])
            names |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    return names


def fit_path_phase(dev) -> dict:
    """``fit``'s device-resident corpus path and its knobs at the full
    speech width, then the slice's main path through the CLI.

    In memory (the training slice's 64 + 32 files, 2 epochs a run, from
    the same weights): the host path against the device path (parameters
    bit-identical, the same launches), the device path with synchronous
    and asynchronous checkpoints (the slots' bytes equal), sync_every 1
    against 2 without a workdir (bit-identical). Then, on disk (80 seeded files): ``train
    speech --cache-dir --trace-dir --async-checkpoints`` (the trace must
    hold K1-K4's kernels; a second corpus build from the cache equals a
    build from the CSVs), ``decode speech`` of a workdir of a msgpack slot
    in the JAX package's layout (counted: the main path's launches) and
    of the ``.pt`` workdir (the same MLF), and ``train speech
    --debug-nans`` on a corpus with NaNs, which must raise."""
    import shutil

    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.data import datasets
    from mgr_tpu_torch.data.batcher import Batcher
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train.loop import fit

    cfg = get_preset("speech")
    B = cfg.batch_size
    feats, labels, lab_len, in_len = _speech_corpus(cfg, N_TRAIN + N_VAL, SEED + 7)
    ids = list(range(1, N_TRAIN + N_VAL + 1))
    data = Batcher(feats, labels, lab_len, in_len, ids,
                   train_ids=ids[:N_TRAIN], val_ids=ids[N_TRAIN:])
    model = build_model(cfg, seed=SEED, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    runs, params = {}, {}
    with tempfile.TemporaryDirectory() as root:
        for tag, kw in (("host", dict(device_data=False)), ("device", dict(device_data=True)),
                        ("device_async", dict(device_data=True, async_checkpoints=True)),
                        ("device_sync_every_1", dict(device_data=True, workdir=None)),
                        ("device_sync_every_2", dict(device_data=True, workdir=None,
                                                     sync_every=2))):
            kw.setdefault("workdir", os.path.join(root, tag))
            model.load_state_dict(init)
            dispatch.reset_launch_counts()
            res = fit(model, data, epochs=FIT_EPOCHS, **kw)
            params[tag] = {k: v.detach().clone() for k, v in res.state.params.items()}
            runs[tag] = {"train_loss": [h["train_loss"] for h in res.history],
                         "launches": dispatch.launch_counts()}
        for a, b in (("host", "device"), ("device", "device_async"),
                     ("device", "device_sync_every_1"),
                     ("device_sync_every_1", "device_sync_every_2")):
            if not all(torch.equal(params[a][k], params[b][k]) for k in params[a]):
                raise AssertionError(f"fit's parameters differ between the {a} and {b} runs")
        if runs["host"]["launches"] != runs["device"]["launches"]:
            raise AssertionError(f"launches differ by path: {runs['host']['launches']} vs "
                                 f"{runs['device']['launches']}")
        slots = sorted(f for f in os.listdir(os.path.join(root, "device"))
                       if not f.endswith("metrics.jsonl"))
        for f in slots:
            with open(os.path.join(root, "device", f), "rb") as x, \
                    open(os.path.join(root, "device_async", f), "rb") as y:
                if x.read() != y.read():
                    raise AssertionError(f"{f}: the async slot's bytes differ from the sync one's")
        slot_mb = {f: os.path.getsize(os.path.join(root, "device", f)) / 2**20 for f in slots}

    # The main path: train speech through the CLI on files, then decode a
    # workdir that holds the JAX package's format only.
    rng = np.random.default_rng(SEED + 13)
    cli_feats = rng.standard_normal((N_CLI_FILES, cfg.maxlen, cfg.num_feats), dtype=np.float32)
    seqs = [list(rng.integers(1, 21, size=rng.integers(1, 9))) for _ in range(N_CLI_FILES)]
    with tempfile.TemporaryDirectory() as root:
        data_dir, label_file = _write_audio_corpus(root, cli_feats, seqs)
        wd, mp, cache, trace = (os.path.join(root, d) for d in ("wd", "msgpack", "cache", "trace"))
        corpus = ["--data-dir", data_dir, "--labels", label_file]
        dispatch.reset_launch_counts()
        train_line = _cli(["train", "speech", "--workdir", wd, "--epochs", "1",
                           "--cache-dir", cache, "--trace-dir", trace, "--async-checkpoints",
                           *corpus])
        os.makedirs(mp)
        shutil.copy(os.path.join(wd, "speech_config.json"), mp)
        with open(os.path.join(mp, "speech_best.msgpack"), "wb") as f:
            f.write(_jax_slot(ckpt_lib.state_path(wd, "speech", "best")))
        dec_line = _cli(["decode", "speech", "--workdir", mp, "--out",
                         os.path.join(root, "msgpack.mlf"), *corpus])
        launches = dispatch.launch_counts()
        if min(launches[k] for k in FIT_KERNELS) <= 0:
            raise AssertionError(f"the main path did not launch K1-K4: {launches}")
        _cli(["decode", "speech", "--workdir", wd, "--out", os.path.join(root, "pt.mlf"),
              *corpus])
        with open(os.path.join(root, "msgpack.mlf")) as a, open(os.path.join(root, "pt.mlf")) as b:
            if a.read() != b.read():
                raise AssertionError("the msgpack workdir decodes to another MLF than the .pt one")
        got = ckpt_lib.read_params(mp, "speech")
        want = ckpt_lib.read_params(wd, "speech")
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("the msgpack slot's parameters differ from the .pt slot's")
        if train_line["epochs_run"] != 1 or dec_line["decoded"] != N_CLI_FILES // B * B:
            raise AssertionError(f"train {train_line}, decode {dec_line}")
        in_trace = _trace_kernels(trace)
        missing = [k for k, name in FIT_KERNELS.items() if not any(name in n for n in in_trace)]
        if missing:
            raise AssertionError(f"the trace of train speech lacks {missing}: {sorted(in_trace)}")
        if len(os.listdir(cache)) != 1:
            raise AssertionError(f"--cache-dir holds {os.listdir(cache)}")
        cached = datasets.build_audio_dataset(data_dir, label_file, cfg, cache_dir=cache)
        parsed = datasets.build_audio_dataset(data_dir, label_file, cfg)
        for attr in ("features", "labels", "label_lengths", "input_lengths", "train_ids",
                     "val_ids"):
            if not np.array_equal(np.asarray(getattr(cached, attr)),
                                  np.asarray(getattr(parsed, attr))):
                raise AssertionError(f"the cached corpus's {attr} differ from the CSVs'")

        nan_root = os.path.join(root, "nan")
        nan_dir, nan_labels = _write_audio_corpus(nan_root, cli_feats[:N_NAN_FILES],
                                                  seqs[:N_NAN_FILES], nan=True)
        try:
            _cli(["train", "speech", "--workdir", os.path.join(nan_root, "wd"), "--epochs", "1",
                  "--batch-size", "2", "--debug-nans", "--data-dir", nan_dir,
                  "--labels", nan_labels])
        except FloatingPointError as exc:
            nan_error = str(exc)[:120]
        else:
            raise AssertionError("train --debug-nans ran through a corpus of NaNs")
        if torch.is_anomaly_enabled():
            raise AssertionError("--debug-nans left autograd's anomaly mode on")

    phase("fit_path", pipeline="speech", B=B, T=cfg.maxlen, H=cfg.encoder.hidden,
          files_train=N_TRAIN, files_val=N_VAL, epochs=FIT_EPOCHS, runs=runs,
          slot_mb=slot_mb,
          cli={"files": N_CLI_FILES, "trace_kernels": sorted(n for n in in_trace if any(
                   k in n for k in FIT_KERNELS.values()))},
          launches=launches, debug_nans_raised=nan_error)
    return launches


def _midpoint_csv(path, rows, seed) -> list:
    """An audio CSV (39 feature columns + file_number) of decimals of 25
    significant digits, each 1e-20 (relative) above or below a float32
    rounding midpoint, which a float64 parse lands on exactly (its float32
    rounding then goes to the even neighbour whichever side the decimal
    lies). Returns the feature cells' text, row by row."""
    from decimal import Decimal, localcontext

    rng = np.random.default_rng(seed)
    n = rows * 39
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    mid = (a.astype(np.float64) + np.nextafter(a, np.float32(np.inf)).astype(np.float64)) / 2
    with localcontext() as ctx:
        ctx.prec = 60
        cells = [format(Decimal(m) * (1 + s * Decimal("1e-20")), ".24e")
                 for m, s in zip(mid.tolist(), rng.choice([-1, 1], size=n).tolist())]
    with open(path, "w") as f:
        f.write(",".join(str(i) for i in range(39)) + ",file_number\n")
        for r in range(rows):
            f.write(",".join(cells[39 * r:39 * (r + 1)]) + ",1\n")
    return cells


def synthetic_phase(dev) -> dict:
    """The last small modules on the card.

    The example (``python -m mgr_tpu_torch.examples.synthetic_end_to_end``)
    at its defaults for 2 epochs, in a subprocess started first, while
    this process holds the CSV reader (built in ``build_phase``) against
    libc's own ``strtof``, value by value, on a file of decimals beside
    float32 rounding midpoints (and counts ``np.loadtxt``'s misses there),
    then, at full width, writes a speech corpus of per-file audio CSVs
    with the port's ``synthetic``, reads it with the parser and with
    ``np.loadtxt`` (whether the two give the same bits), and runs ``train speech``, ``decode
    speech`` and ``score`` through the CLI (BiLSTM(500)x2 at T=1900
    through K1-K4). Once the example has ended, alone: the learning run,
    the example's corpus and widths with input noise and dropout 0,
    ``fit`` without a workdir, decoded to an MLF and scored, the train
    split's accuracy at least ``SYN_MIN_ACCURACY``. Returns the launches
    of the full-width commands and the learning run."""
    import ctypes
    import io
    from unittest import mock

    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.core.metrics import MetricsLogger
    from mgr_tpu_torch.data import datasets, fastcsv, formats, synthetic, vocab
    from mgr_tpu_torch.decode import Decoder, mlf, read_mlf, score_sequences
    from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
    from mgr_tpu_torch.examples import synthetic_end_to_end as example
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train.loop import fit

    libc = ctypes.CDLL(None)
    libc.strtof.restype = ctypes.c_float
    libc.strtof.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    out = {}
    with tempfile.TemporaryDirectory() as root, subprocess.Popen(
            [sys.executable, "-m", "mgr_tpu_torch.examples.synthetic_end_to_end",
             os.path.join(root, "example")],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ, "MGR_TPU_EXAMPLE_EPOCHS": "2"}) as proc:
        try:
            # The reader, bit for bit against strtof.
            path = os.path.join(root, "audio_1.csv")
            cells = _midpoint_csv(path, SYN_MID_ROWS, SEED + 17)
            want = np.array([libc.strtof(c.encode(), None) for c in cells], np.float32)
            got = formats.load_audio_file_csv(path)
            raw = fastcsv.load_numeric_csv(path)[:, :39]
            loadtxt = fastcsv.numpy_fallback(path, True)[:, :39]
            misses = {name: int((x.ravel().view(np.uint32) != want.view(np.uint32)).sum())
                      for name, x in (("load_audio_file_csv", got), ("load_numeric_csv", raw),
                                      ("np_loadtxt", loadtxt))}
            out["reader"] = {"values": len(cells), "bits_differing": misses}
            if misses["load_audio_file_csv"] or misses["load_numeric_csv"]:
                raise AssertionError(f"the CSV reader differs from strtof: {misses}")

            # Full width: the speech corpus on disk, read twice, then the CLI.
            data_dir, label_file, labels = synthetic.make_audio_dataset(
                os.path.join(root, "speech"), **SYN_AUDIO)
            speech = get_preset("speech")
            fast = datasets.build_audio_dataset(data_dir, label_file, speech)
            with mock.patch.object(fastcsv, "load_numeric_csv", fastcsv.numpy_fallback):
                slow = datasets.build_audio_dataset(data_dir, label_file, speech)
            wd = os.path.join(root, "wd")
            corpus = ["--data-dir", data_dir, "--labels", label_file]
            dispatch.reset_launch_counts()
            train_line = _cli(["train", "speech", "--workdir", wd, "--epochs", "1",
                               "--batch-size", "32", *corpus])
            hyps, refs = os.path.join(root, "speech.mlf"), os.path.join(root, "speech_refs.mlf")
            dec_line = _cli(["decode", "speech", "--workdir", wd, "--out", hyps, *corpus])
            full_launches = dispatch.launch_counts()
            mlf.write_mlf(refs, [(mlf.entry_name(fid, "_audio"),
                                  vocab.ids_to_tokens(vocab.class_seq_to_word_seq(seq),
                                                      vocab.WORDS))
                                 for fid, seq in labels.items()])
            score_line = _cli(["score", refs, hyps, "--partial"])
            out["full_width"] = {
                "files": SYN_AUDIO["n_files"], "csv_mb": sum(
                    os.path.getsize(os.path.join(data_dir, f))
                    for f in os.listdir(data_dir)) / 1e6,
                "corpus_bits_equal": bool(np.array_equal(fast.features.view(np.uint32),
                                                         slow.features.view(np.uint32))),
                "B": 32, "T": speech.maxlen, "H": speech.encoder.hidden,
                "decoded": dec_line["decoded"], "score": score_line,
                "launches": full_launches}

            # The example at its defaults, as a user runs it.
            stdout, stderr = proc.communicate(timeout=300)
        except BaseException:
            proc.kill()
            raise
        out["example"] = {"rc": proc.returncode, "mlf_scoring": [ln for ln in stdout.splitlines()
                                          if ln.startswith("MLF scoring:")]}
        if proc.returncode != 0 or not out["example"]["mlf_scoring"]:
            raise AssertionError(f"the example failed: {stdout[-1500:]}{stderr[-1500:]}")

        # The learning run, alone: the example's corpus and widths, noise and dropout 0.
        csv_path, label_file, labels = example.make_corpus(os.path.join(root, "learn"))
        cfg = example.example_config(noise=0.0, dropout=0.0)
        data = datasets.build_skeletal_dataset(csv_path, label_file, cfg)
        model = build_model(cfg, device=dev)
        res = fit(model, data, epochs=SYN_LEARN_EPOCHS, metrics=MetricsLogger(stream=io.StringIO()))
        fit_launches = {k: v - full_launches[k] for k, v in dispatch.launch_counts().items()}
        dec = Decoder.for_model(model, "skeletal")
        hyps, refs = os.path.join(root, "sk.mlf"), os.path.join(root, "sk_refs.mlf")
        dec.write_mlf(hyps, dec.decode_batches(data.epoch(cfg.batch_size, train=False),
                                               use_lengths=True))
        mlf.write_mlf(refs, [(mlf.entry_name(fid), [vocab.GESTURE_CODES[c] for c in seq])
                             for fid, seq in labels.items()])
        accuracy = evaluate_accuracy(model, data, train_split=True, use_lengths=True)
        launches = dispatch.launch_counts()
        out["learn"] = {"B": cfg.batch_size, "T": cfg.maxlen, "H": cfg.encoder.hidden,
                        "epochs": res.epochs_run, "final_train_loss": res.history[-1]["train_loss"],
                        "mlf_scoring": score_sequences(read_mlf(refs), read_mlf(hyps),
                                                       ignore_missing=True),
                        "train_split_accuracy": accuracy, "fit_launches": fit_launches}
        out["launches"] = launches
        phase("synthetic", **out)
        if accuracy["accuracy"] < SYN_MIN_ACCURACY:
            raise AssertionError(f"the learning run reached a train-split accuracy of "
                                 f"{accuracy['accuracy']} after {res.epochs_run} epochs")
        if train_line["epochs_run"] != 1 or dec_line["decoded"] <= 0:
            raise AssertionError(f"train {train_line}, decode {dec_line}")
        if min(launches[k] for k in FIT_KERNELS) <= 0:
            raise AssertionError(f"the synthetic path did not launch K1-K4: {launches}")
    return launches


def _finite_losses(row) -> list:
    """The losses of a driver's JSON row (every ``best_*_loss``, nested)."""
    if not isinstance(row, dict):
        return []
    return [v for k, v in row.items() if k.startswith("best_") and k.endswith("_loss")] + \
        [x for v in row.values() for x in _finite_losses(v)]


def examples_phase(dev) -> dict:
    """The port's four learning drivers (``mgr_tpu_torch/examples``) at full
    width for 2 epochs on a few files (``EXAMPLES_ENV``): the convergence
    and generalization checks' late-fusion stage (T=1900), the convergence
    check's early-fusion (T=96) and rgb (T=64) stages and the measured
    curriculum in this process, each run counted (counts set to 0 before
    it, read after), and the A/B's biased arm through ``python -m`` in a
    subprocess, started first. Each JSON row has the JAX script's keys and
    finite losses; the curriculum's finetune leg ran. Returns each
    in-process run's launches."""
    from unittest import mock

    from mgr_tpu_torch.examples import (convergence_check, curriculum_bench,
                                        generalization_check)
    from mgr_tpu_torch.ops import dispatch

    repo = os.path.dirname(os.path.abspath(__file__))
    rows, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:
        ab_env = {**os.environ, **EXAMPLES_ENV["skeletal_bias_ab"],
                  "MGR_TPU_AB_ROOT": os.path.join(root, "ab_corpus"),
                  "MGR_TPU_AB_WORKDIR": os.path.join(root, "ab_wd")}
        with subprocess.Popen(
                [sys.executable, "-m", "mgr_tpu_torch.examples.skeletal_bias_ab", "biased",
                 "--device", dev.type],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=ab_env) as proc:
            try:
                drivers = {"convergence_check": convergence_check,
                           "generalization_check": generalization_check,
                           "curriculum_bench": curriculum_bench}
                for name, env in EXAMPLES_ENV.items():
                    driver = drivers.get(name.split(":")[0])
                    if driver is None:
                        continue  # the A/B: the subprocess
                    env = dict(env)
                    if name.startswith("convergence_check"):
                        env["MGR_TPU_CONV_ROOT"] = os.path.join(root, name.replace(":", "_"))
                    dispatch.reset_launch_counts()
                    with mock.patch.dict(os.environ, env):
                        rows[name] = driver.main(device=str(dev))
                    launches[name] = dispatch.launch_counts()
                stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
            except BaseException:
                proc.kill()
                raise
        if proc.returncode != 0:
            raise AssertionError(f"skeletal_bias_ab exited {proc.returncode}: "
                                 f"{stderr[-2000:]}")
        rows["skeletal_bias_ab"] = json.loads(stdout.strip().splitlines()[-1])
    want = {
        "convergence_check": ("late_fusion", {"train_accuracy", "train_wer",
                                              "train_accuracy_no_threshold",
                                              "encoder_train_accuracy", "anneal_epochs",
                                              "finetune_encoders", "best_train_loss"}),
        "convergence_check:early_fusion": ("early_fusion", {"train_accuracy", "train_wer",
                                                            "best_train_loss"}),
        "convergence_check:rgb": ("rgb", {"train_accuracy", "train_wer", "best_train_loss"}),
        "generalization_check": (None, {"pretrain_speech", "pretrain_skeletal", "late_fusion"}),
        "curriculum_bench": ("stages", {"speech", "skeletal", "late_fusion"}),
        "skeletal_bias_ab": (None, {"arm", "head_blank_bias", "train_accuracy",
                                    "best_train_loss"}),
    }
    for name, (sub, keys) in want.items():
        row = rows[name] if sub is None else rows[name].get(sub, {})
        losses = _finite_losses(rows[name])
        if not keys <= set(row) or not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: {rows[name]}")
    lf = rows["curriculum_bench"]["stages"]["late_fusion"]
    if lf.get("finetune_epochs") != 1 or lf.get("reached_accuracy_target") is not False \
            or rows["convergence_check"]["late_fusion"]["finetune_encoders"] is not True:
        raise AssertionError(f"the finetune legs did not run: {rows}")
    for name, c in launches.items():
        if min(c[k] for k in KERNELS[:4]) <= 0:
            raise AssertionError(f"{name} did not launch K1-K4: {c}")
    phase("examples", T={"late_fusion, curriculum, A/B": 1900, "early_fusion": 96, "rgb": 64},
          hidden_scale=1, rows=rows, launches=launches)
    return launches


def _two_stream_corpus(cfg, n, seed):
    """n files of seeded random audio (T, 39) and skeletal (T, 20)
    features and labels (1..N gestures)."""
    rng = np.random.default_rng(seed)
    T = cfg.maxlen
    a = rng.standard_normal((n, T, cfg.num_feats), dtype=np.float32)
    s = rng.standard_normal((n, T, cfg.second_stream_feats), dtype=np.float32)
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=n).astype(np.int32)
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    in_len = np.full((n,), T - cfg.ctc.trim_frames, np.int32)
    return (a, s), labels, lab_len, in_len


def _batcher(corpus, n_train):
    from mgr_tpu_torch.data.batcher import Batcher

    feats, labels, lab_len, in_len = corpus
    ids = list(range(1, len(labels) + 1))
    return Batcher(feats, labels, lab_len, in_len, ids, train_ids=ids[:n_train],
                   val_ids=ids[n_train:])


def _kernel_vs_plain_step(model, batch, key, dev):
    """One step's loss and gradients through the kernels and through the
    plain versions (a copy of the model, the same masks): the loss's
    relative error, each gradient's relative Frobenius error."""
    import copy

    from mgr_tpu_torch.train import step as step_lib

    twin = copy.deepcopy(model)
    tb = step_lib.batch_to_device(batch, dev)
    loss_k, grads_k = step_lib._loss_and_grads(model, dict(model.named_parameters()), tb, key)
    grads_k = {k: g.clone() for k, g in grads_k.items()}
    with plain_path():
        loss_p, grads_p = step_lib._loss_and_grads(twin, dict(twin.named_parameters()), tb, key)
    for p in model.parameters():
        p.grad = None
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = {k: float((grads_k[k] - g).norm() / g.norm().clamp_min(1e-30))
                for k, g in grads_p.items()}
    if loss_rel > TOL_LOSS_REL or max(grad_rel.values()) > TOL_GRAD_REL:
        raise AssertionError(
            f"{model.config.name}: the kernel train step disagrees with the plain one: loss "
            f"rel {loss_rel} (tol {TOL_LOSS_REL}), grads {grad_rel} (tol {TOL_GRAD_REL})")
    return {"loss_rel_err": loss_rel, "grad_max_rel_err": max(grad_rel.values()),
            "grad_rel_err": grad_rel}


def _step_launches(model, batch, key):
    """The launch counts of one train step."""
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train import step as step_lib

    state = step_lib.create_train_state(model)
    dispatch.reset_launch_counts()
    _, m = step_lib.make_train_step(model)(state, batch, key)
    float(m["loss"])
    return dispatch.launch_counts()


def fusion_phase(dev) -> dict:
    """The two fusion families at full width (B=32, T=1900), trained and
    served through the kernels, files cut to 64 train + 32 val.

    Early fusion (audio 39 + skeletal 20 -> BiLSTM(500)x2 -> Dense(22)):
    ``fit`` for 2 epochs, the best slot reloaded and decoded. Late fusion:
    donors from 1-epoch fits of speech and skeletal into one workdir, the
    graft (``build_fusion_with_pretrained``), ``fit`` for 2 epochs over the
    frozen encoders (K1 at H=500 and 300, the fusion BiLSTM(100) on the
    1600-wide concat), decode and evaluate of the best slot. The launch
    counts of that run are the fusion path's. Then, for each family, one
    step's launch counts (late fusion: K2 once, for the fusion layer
    alone), the kernel step against the plain one, and a learning check;
    the frozen encoders bit-equal to the donors."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core import prng
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.curriculum import build_fusion_with_pretrained
    from mgr_tpu_torch.train.loop import fit

    n = N_FUS_TRAIN + N_FUS_VAL
    ef_cfg, lf_cfg = get_preset("early_fusion"), get_preset("late_fusion")
    B = ef_cfg.batch_size
    ef_data = _batcher(_two_stream_corpus(ef_cfg, n, SEED + 20), N_FUS_TRAIN)
    lf_data = _batcher(_two_stream_corpus(lf_cfg, n, SEED + 21), N_FUS_TRAIN)
    donors = {name: _batcher(_speech_corpus(get_preset(name), n, SEED + 22 + i), N_FUS_TRAIN)
              for i, name in enumerate(("speech", "skeletal"))}
    one = {tag: next(iter(d.epoch(B, train=False))) for tag, d in
           (("early_fusion", ef_data), ("late_fusion", lf_data))}
    out = {}

    with tempfile.TemporaryDirectory() as workdir:
        for name, data in donors.items():  # the donors' fits are not the fusion path
            fit(build_model(get_preset(name), seed=SEED, device=dev), data, workdir=workdir,
                epochs=1)
        ef = build_model(ef_cfg, seed=SEED, device=dev)
        dispatch.reset_launch_counts()
        ef_res = fit(ef, ef_data, workdir=workdir, epochs=FUS_EPOCHS)
        fresh = build_model(ef_cfg, seed=SEED + 99, device=dev)
        ckpt_lib.load_params(workdir, "early_fusion", fresh, slot="best")
        ef_decoded = Decoder.for_model(fresh, "early_fusion").decode_batches(
            [one["early_fusion"]])
        lf = build_fusion_with_pretrained(workdir, device=dev)
        lf_res = fit(lf, lf_data, workdir=workdir, epochs=FUS_EPOCHS)
        best = build_fusion_with_pretrained(workdir, device=dev)
        ckpt_lib.load_params(workdir, "late_fusion", best, slot="best")
        lf_decoded = Decoder.for_model(best, "late_fusion").decode_batches([one["late_fusion"]])
        lf_metrics = evaluate_accuracy(best, lf_data)
        launches = dispatch.launch_counts()
        donor_enc = {name: ckpt_lib.read_params(workdir, name) for name in donors}

    path = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd")
    if min(launches[k] for k in path) <= 0 or any(v for k, v in launches.items()
                                                  if k not in path):
        raise AssertionError(f"the fusion path took the wrong kernels: {launches}")
    for tag, res, decoded in (("early_fusion", ef_res, ef_decoded),
                              ("late_fusion", lf_res, lf_decoded)):
        if res.epochs_run != FUS_EPOCHS or not all(
                np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in res.history):
            raise AssertionError(f"{tag}: fit ran {res.epochs_run} epochs: {res.history}")
        if len(decoded) != B:
            raise AssertionError(f"{tag}: the best slot decoded {len(decoded)} of {B}")
    # The frozen encoders end the late-fusion fit as the donors' best slots.
    state = lf.state_dict()
    unchanged = all(torch.equal(state[f"{name}.{k[len('encoder.'):]}"].cpu(), v)
                    for name, enc in donor_enc.items() for k, v in enc.items()
                    if k.startswith("encoder."))
    if not unchanged:
        raise AssertionError("late fusion's frozen encoders changed in training")

    key = prng.fold_name(prng.root_key(SEED), "dropout")
    want_step = {"early_fusion": {"bilstm_tm_fwd": 2, "bilstm_tm_bwd": 2},
                 "late_fusion": {"bilstm_tm_fwd": 5, "bilstm_tm_bwd": 1}}
    for tag, model, res in (("early_fusion", ef, ef_res), ("late_fusion", lf, lf_res)):
        batch = one[tag][1]
        want = {k: 0 for k in KERNELS}
        want.update(want_step[tag], ctc_fwd=1, ctc_bwd=1)
        per_step = _step_launches(model, batch, key)
        if per_step != want:
            raise AssertionError(f"{tag}: one train step launched {per_step}, want {want}")
        check = _kernel_vs_plain_step(model, batch, prng.fold_in(key, 1000), dev)
        eval_step = step_lib.make_eval_step(model)
        state = step_lib.create_train_state(model)
        train_step = step_lib.make_train_step(model)
        before = float(eval_step(batch))
        for i in range(LEARN_STEPS):
            state, _ = train_step(state, batch, prng.fold_in(key, 2000 + i))
        after = float(eval_step(batch))
        if not after < before:
            raise AssertionError(f"{tag}: no learning: eval loss {before} -> {after}")
        out[tag] = {
            "step_launches": per_step,
            "epoch_train_loss": [h["train_loss"] for h in res.history],
            "epoch_val_loss": [h["val_loss"] for h in res.history], **check,
            "learning_check": {"eval_loss_before": before, "eval_loss_after": after,
                               "steps": LEARN_STEPS}}
    out["late_fusion"].update(frozen_encoders_bit_unchanged=True,
                              evaluate={k: lf_metrics[k] for k in ("accuracy", "N")})
    phase("fusion", B=B, T=ef_cfg.maxlen, files_train=N_FUS_TRAIN, files_val=N_FUS_VAL,
          epochs=FUS_EPOCHS, launches=launches, tol_loss_rel=TOL_LOSS_REL,
          tol_grad_rel=TOL_GRAD_REL, **out)
    return launches


def _video_corpus(root, cfg, n, seed):
    """n seeded videos ``Sample#####_color.npy`` of 1400-2099 uint8 frames
    of D x D pixels under ``root``/videos (most padded to T, some cut to
    it) and their labels CSV (1..N gestures of classes 1..20)."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "videos")
    os.makedirs(data_dir)
    D = cfg.cnn.img_dim
    rows = ["Id,Sequence"]
    for fid in range(1, n + 1):
        frames = int(rng.integers(1400, 2100))
        np.save(os.path.join(data_dir, f"Sample{fid:05d}_color.npy"),
                rng.integers(0, 256, (frames, D, D), dtype=np.uint8))
        k = int(rng.integers(1, cfg.max_label_len + 1))
        rows.append(f"{fid}," + " ".join(str(c) for c in rng.integers(1, cfg.nb_classes - 1,
                                                                       size=k)))
    labels = os.path.join(root, "rgb_labels.csv")
    with open(labels, "w") as f:
        f.write("\n".join(rows) + "\n")
    return data_dir, labels


def rgb_phase(dev) -> dict:
    """The rgb family at full width (60x60x1 frames, T=1900, CNN 16/32/48,
    BiLSTM(512)x2, Dense(22), B=8, remat on), trained and served through the
    kernels, the file count cut to 40 seeded videos on disk (32 train + 8
    val by the preset's split): ``fit`` for 2 epochs on ``build_rgb_dataset``,
    the best slot reloaded, decoded to MLF and evaluated, and one video
    through ``infer rgb`` (uint8 frames through the normalisation); the
    launch counts of that run are the rgb path's. Then one step's launches
    (K1 2, K2 2, K3 1, K4 1) and peak memory, the kernel step against the
    plain one (``cnn.*`` included), B=1 decode against ``infer rgb``, and a
    learning check."""
    import io

    from mgr_tpu_torch.cli.main import main as cli_main
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core import prng
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.data import formats
    from mgr_tpu_torch.data.batcher import pad_or_truncate
    from mgr_tpu_torch.data.datasets import build_rgb_dataset
    from mgr_tpu_torch.data.vocab import DECODE_IGNORE_LIST
    from mgr_tpu_torch.decode.decoder import MLF_FILENAMES, Decoder
    from mgr_tpu_torch.decode.evaluate import evaluate_accuracy
    from mgr_tpu_torch.decode.mlf import read_mlf
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.loop import fit

    cfg = get_preset("rgb")
    B, T, trim = cfg.batch_size, cfg.maxlen, cfg.ctc.trim_frames
    with tempfile.TemporaryDirectory() as root:
        data_dir, labels = _video_corpus(root, cfg, N_RGB_FILES, SEED + 42)
        data = build_rgb_dataset(data_dir, labels, cfg)
        if (len(data.train_ids), len(data.val_ids)) != (32, 8):
            raise AssertionError(f"rgb split {len(data.train_ids)} / {len(data.val_ids)}")
        model = build_model(cfg, seed=SEED, device=dev)
        workdir = os.path.join(root, "runs")
        torch.cuda.reset_peak_memory_stats(dev)
        dispatch.reset_launch_counts()
        res = fit(model, data, workdir=workdir, epochs=RGB_EPOCHS)
        fit_peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        best = build_model(cfg, seed=SEED + 99, device=dev)
        ckpt_lib.load_params(workdir, "rgb", best, slot="best")
        dec = Decoder.for_model(best, "rgb")
        results = dec.decode_batches(data.epoch(B, train=False))
        mlf_path = os.path.join(root, MLF_FILENAMES["rgb"])
        dec.write_mlf(mlf_path, results)
        n_mlf = len(read_mlf(mlf_path))
        metrics = evaluate_accuracy(best, data)
        video = os.path.join(data_dir, "Sample00001_color.npy")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = cli_main(["infer", "rgb", video, "--workdir", workdir])
        infer_tokens = json.loads(out.getvalue().strip().splitlines()[-1])["tokens"]
        launches = dispatch.launch_counts()
        batch = next(iter(data.epoch(B, train=False)))[1]
        x1, true_len = pad_or_truncate((formats.load_video_npy(video) - 128.0) / 255.0, T)
    path = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd")
    if min(launches[k] for k in path) <= 0 or any(v for k, v in launches.items()
                                                  if k not in path):
        raise AssertionError(f"the rgb path took the wrong kernels: {launches}")
    if res.epochs_run != RGB_EPOCHS or not all(
            np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in res.history):
        raise AssertionError(f"rgb: fit ran {res.epochs_run} epochs: {res.history}")
    kept = [fid for fid, _ in results if fid not in DECODE_IGNORE_LIST]
    if len(results) != 8 or n_mlf != len(kept) or metrics["N"] <= 0 or rc != 0:
        raise AssertionError(f"rgb: decoded {len(results)}, MLF {n_mlf}, evaluate {metrics}")

    # B=1 serving: the same video as infer, through the same decode step.
    one = {"inputs": x1[None], "input_length": np.asarray([true_len - trim], np.int32)}
    if dec.decode_batches([((1,), one)])[0][1] != infer_tokens:
        raise AssertionError("rgb: infer's tokens differ from the decode step's")
    with torch.inference_mode():
        logits = best(torch.from_numpy(batch["inputs"]).to(dev))
    if logits.shape != (B, T, cfg.nb_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"rgb: bad logits {tuple(logits.shape)}")
    del best, logits

    key = prng.fold_name(prng.root_key(SEED), "dropout")
    torch.cuda.reset_peak_memory_stats(dev)
    per_step = _step_launches(model, batch, key)
    step_peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    want = {k: 0 for k in KERNELS}
    want.update(bilstm_tm_fwd=2, bilstm_tm_bwd=2, ctc_fwd=1, ctc_bwd=1)
    if per_step != want:
        raise AssertionError(f"rgb: one train step launched {per_step}, want {want}")
    check = _kernel_vs_plain_step(model, batch, prng.fold_in(key, 1000), dev)
    if not any(k.startswith("cnn.conv_") for k in check["grad_rel_err"]):
        raise AssertionError("rgb: the step's gradients lack the conv kernels")
    eval_step = step_lib.make_eval_step(model)
    state = step_lib.create_train_state(model)
    train_step = step_lib.make_train_step(model)
    before = float(eval_step(batch))
    for i in range(LEARN_STEPS):
        state, _ = train_step(state, batch, prng.fold_in(key, 2000 + i))
    after = float(eval_step(batch))
    if not after < before:
        raise AssertionError(f"rgb: no learning: eval loss {before} -> {after}")
    phase("rgb", B=B, T=T, img=cfg.cnn.img_dim, channels=list(cfg.cnn.channels),
          H=cfg.encoder.hidden, remat=cfg.cnn.remat, files_train=len(data.train_ids),
          files_val=len(data.val_ids), epochs=RGB_EPOCHS, launches=launches,
          epoch_train_loss=[h["train_loss"] for h in res.history],
          epoch_val_loss=[h["val_loss"] for h in res.history],
          mlf_entries=n_mlf, evaluate={k: metrics[k] for k in ("accuracy", "N")},
          infer_tokens=len(infer_tokens), step_launches=per_step,
          fit_peak_mem_gb=fit_peak_gb, step_peak_mem_gb=step_peak_gb, **check,
          tol_loss_rel=TOL_LOSS_REL, tol_grad_rel=TOL_GRAD_REL,
          learning_check={"eval_loss_before": before, "eval_loss_after": after,
                          "steps": LEARN_STEPS})
    del model, state
    torch.cuda.empty_cache()
    return launches


def _write_raw_recordings(root, seed):
    """Seeded raw inputs of the prepare slice under ``root``: WAVs (16 kHz,
    16-bit mono: noise under a few tones), Kinect CSVs (a random walk of
    integer joints, some past the frame), annotation files (1-8 gestures
    a file), and uint8 gray videos with a Kinect CSV each."""
    import wave

    from mgr_tpu_torch.data.skeletal_pipeline import KINECT_COLUMNS
    from mgr_tpu_torch.data.vocab import GESTURE_NAME_TO_ID

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("wavs", "kinect", "labels", "videos")}
    for d in dirs.values():
        os.makedirs(d)
    t = np.arange(PREP_WAV_S * PREP_RATE) / PREP_RATE
    names = sorted(GESTURE_NAME_TO_ID)
    for fid in PREP_TRAIN_IDS + PREP_VAL_IDS:
        tones = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 4000, size=3))
        wav = (2000 * tones + 500 * rng.standard_normal(t.size)).astype("<i2")
        with wave.open(os.path.join(dirs["wavs"], f"Sample{fid:05d}_audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(PREP_RATE)
            w.writeframes(wav.tobytes())
        tracks = []
        for _ in KINECT_COLUMNS:
            start = rng.integers(150, 450, size=2)
            steps = rng.integers(-8, 9, size=(PREP_FRAMES, 2)) * (rng.random((PREP_FRAMES, 1)) < 0.5)
            tracks.append(np.clip(start + np.cumsum(steps, axis=0), 0, 700))
        with open(os.path.join(dirs["kinect"], f"Sample{fid:05d}_skeleton.csv"), "w") as f:
            f.write(",".join(["frame"] + list(KINECT_COLUMNS)) + "\n")
            for i in range(PREP_FRAMES):
                f.write(",".join([str(i)] + [f"[{tr[i, 0]} {tr[i, 1]}]" for tr in tracks]) + "\n")
        ends = np.sort(rng.choice(np.arange(20, PREP_FRAMES, 20), size=int(rng.integers(1, 9)),
                                  replace=False))
        with open(os.path.join(dirs["labels"], f"Sample{fid:05d}_data_labels.csv"), "w") as f:
            for end in ends:
                f.write(f"{names[int(rng.integers(len(names)))]},0,{end - 19},0,{end}\n")
    for fid in PREP_VIDEO_IDS:
        np.save(os.path.join(dirs["videos"], f"Sample{fid:05d}_color.npy"),
                rng.integers(0, 256, (PREP_FRAMES, 480, 640), dtype=np.uint8))
    return dirs


def _cli(argv):
    """One command of the port's CLI: its printed JSON line."""
    import io

    from mgr_tpu_torch.cli.main import main as cli_main

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _concat_audio_csvs(audio_dir, ids, out):
    """Per-file audio CSVs -> one monolithic CSV (the header once)."""
    with open(out, "w") as f:
        for i, fid in enumerate(ids):
            with open(os.path.join(audio_dir, f"audio_{fid}.csv")) as src:
                lines = src.readlines()
            f.writelines(lines if i == 0 else lines[1:])


def _mfcc_err(got, want):
    """Max |got - want| and the largest excess over rtol |want| + atol."""
    diff = (got - want).abs()
    excess = diff - (TOL_MFCC_RTOL * want.abs() + TOL_MFCC_ATOL)
    return float(diff.max()), float(excess.max())


def prepare_phase(dev) -> dict:
    """The data-preparation slice at the reference's sizes, on seeded raw
    recordings in a temp dir: ``prepare-audio`` (8 WAVs of 95 s),
    ``prepare-skeletal --split-at`` (8 Kinect CSVs of 1,900 frames),
    ``prepare-rgb`` (2 videos of 1,900 480x640 frames) on the card and
    ``mix`` through the port's CLI, ``build_label_csv`` on 8 annotation
    files; each featurizer's card output against the port's CPU output on
    one full-size file; then ``train speech`` (1 epoch, full width, the
    batch cut to 2 for 8 files) and ``decode speech`` through the CLI on the
    prepared corpus: that run's K1-K4 launches are the prepare path's."""
    from mgr_tpu_torch.data import audio_pipeline, rgb_pipeline, skeletal_pipeline
    from mgr_tpu_torch.data.formats import list_audio_files, load_label_csv, write_label_csv
    from mgr_tpu_torch.data.labels_pipeline import build_label_csv
    from mgr_tpu_torch.decode.mlf import read_mlf
    from mgr_tpu_torch.ops import dispatch

    cpu = torch.device("cpu")
    all_ids = PREP_TRAIN_IDS + PREP_VAL_IDS
    with tempfile.TemporaryDirectory() as root:
        raw = _write_raw_recordings(root, SEED + 55)
        out = {k: os.path.join(root, k) for k in ("audio", "rois", "mixed", "runs")}
        sk_train, sk_val = os.path.join(root, "sk_train.csv"), os.path.join(root, "sk_val.csv")
        line = _cli(["prepare-audio", "--wav-dir", raw["wavs"], "--out-dir", out["audio"]])
        if line != {"files": len(all_ids)} or list_audio_files(out["audio"]) != sorted(all_ids):
            raise AssertionError(f"prepare-audio: {line}")
        line = _cli(["prepare-skeletal", "--raw-dir", raw["kinect"], "--out-csv", sk_train,
                     "--val-csv", sk_val, "--split-at", str(PREP_SPLIT_AT)])
        if line != {"videos": len(all_ids)}:
            raise AssertionError(f"prepare-skeletal: {line}")
        line = _cli(["prepare-rgb", "--video-dir", raw["videos"], "--skeletal-dir",
                     raw["kinect"], "--out-dir", out["rois"]])
        if line != {"videos": len(PREP_VIDEO_IDS)}:
            raise AssertionError(f"prepare-rgb: {line}")

        # Labels: one CSV for all files (the speech fit), one per side for mix.
        labels_all = os.path.join(root, "labels.csv")
        labels = build_label_csv(raw["labels"], labels_all)
        lt, lv = os.path.join(root, "labels_train.csv"), os.path.join(root, "labels_val.csv")
        write_label_csv(lt, {k: labels[k] for k in PREP_TRAIN_IDS})
        write_label_csv(lv, {k: labels[k] for k in PREP_VAL_IDS})
        if load_label_csv(labels_all) != labels or sorted(labels) != sorted(all_ids):
            raise AssertionError(f"build_label_csv: {labels}")
        at, av = os.path.join(root, "audio_train.csv"), os.path.join(root, "audio_val.csv")
        _concat_audio_csvs(out["audio"], PREP_TRAIN_IDS, at)
        _concat_audio_csvs(out["audio"], PREP_VAL_IDS, av)
        line = _cli(["mix", "--audio-train", at, "--audio-val", av, "--skeletal-train", sk_train,
                     "--skeletal-val", sk_val, "--train-labels", lt, "--val-labels", lv,
                     "--out-root", out["mixed"], "--n-moved", str(PREP_MOVED)])
        moved = len(list_audio_files(os.path.join(out["mixed"], "train_audio")))
        if line != {"moved": PREP_MOVED, "kept": len(PREP_VAL_IDS) - PREP_MOVED} or \
                moved != len(PREP_TRAIN_IDS) + PREP_MOVED:
            raise AssertionError(f"mix: {line}, {moved} train audio files")

        # Card against CPU, one full-size file of each featurizer.
        wav = os.path.join(raw["wavs"], "Sample00001_audio.wav")
        on = (("card", dev), ("cpu", cpu))
        feats = {k: torch.from_numpy(audio_pipeline.featurize_wav(wav, device=d)) for k, d in on}
        mfcc_abs, mfcc_excess = _mfcc_err(feats["card"], feats["cpu"])
        n_mfcc = 1 + (PREP_WAV_S * PREP_RATE - 400) // 160
        if feats["card"].shape != (n_mfcc, 39) or mfcc_excess > 0:
            raise AssertionError(f"MFCC card vs CPU: {tuple(feats['card'].shape)}, {mfcc_abs}")
        joints = skeletal_pipeline.parse_kinect_csv(
            os.path.join(raw["kinect"], "Sample00001_skeleton.csv"))
        kin = {k: skeletal_pipeline.video_features(joints, device=d) for k, d in on}
        kin_int_equal = bool((kin["card"][:, 4:6] == kin["cpu"][:, 4:6]).all())
        kin_err = float(np.abs(kin["card"] - kin["cpu"]).max())
        if kin["card"].shape != (PREP_FRAMES, 20) or not kin_int_equal or kin_err > TOL_KIN:
            raise AssertionError(f"kinematics card vs CPU: {kin_int_equal}, {kin_err}")
        video = os.path.join(raw["videos"], "Sample00001_color.npy")
        roi = {k: rgb_pipeline.extract_video(video, joints["hip"], joints["shc"], device=d)
               for k, d in on}
        roi_err = float(np.abs(roi["card"] - roi["cpu"]).max())
        written = np.load(os.path.join(out["rois"], "Sample00001_color.npy"))
        near_int = np.abs(roi["cpu"] - np.round(roi["cpu"])) < TOL_ROI
        if roi["card"].shape != (PREP_FRAMES, 60, 60, 1) or roi_err > TOL_ROI or \
                ((written != roi["cpu"].astype(np.uint8)) & ~near_int).any():
            raise AssertionError(f"ROI card vs CPU: {roi_err}")
        del roi

        # The prepared corpus trained and decoded through the kernels.
        dispatch.reset_launch_counts()
        line = _cli(
            ["train", "speech", "--data-dir", out["audio"], "--labels", labels_all,
             "--workdir", out["runs"], "--epochs", "1", "--batch-size", str(PREP_BATCH)])
        if not np.isfinite(line["best_val_loss"]) or line["epochs_run"] != 1:
            raise AssertionError(f"train speech on the prepared corpus: {line}")
        mlf = os.path.join(root, "speech.mlf")
        line = _cli(
            ["decode", "speech", "--workdir", out["runs"], "--data-dir", out["audio"],
             "--labels", labels_all, "--out", mlf])
        launches = dispatch.launch_counts()
        if line["decoded"] != len(all_ids) or len(read_mlf(mlf)) != len(all_ids):
            raise AssertionError(f"decode speech on the prepared corpus: {line}")
    path = ("bilstm_tm_fwd", "bilstm_tm_bwd", "ctc_fwd", "ctc_bwd")
    if min(launches[k] for k in path) <= 0 or any(v for k, v in launches.items()
                                                  if k not in path):
        raise AssertionError(f"the prepare path took the wrong kernels: {launches}")
    phase("prepare", card=_smi(), wavs=len(all_ids), wav_s=PREP_WAV_S, kinect_csvs=len(all_ids),
          videos=len(PREP_VIDEO_IDS), frames=PREP_FRAMES,
          card_vs_cpu={
              "mfcc": {"shape": list(feats["card"].shape), "max_abs_err": mfcc_abs,
                       "max_excess_over_tol": mfcc_excess, "rtol": TOL_MFCC_RTOL,
                       "atol": TOL_MFCC_ATOL},
              "kinematics": {"integer_columns_equal": kin_int_equal, "max_abs_err": kin_err,
                             "tol": TOL_KIN},
              "roi": {"max_abs_err": roi_err, "tol": TOL_ROI}},
          train={"batch": PREP_BATCH, "epochs": 1}, decode={"files": len(all_ids)},
          launches=launches)
    return launches


def _bilstm_at(dev, B, H, store_c) -> dict:
    """K1 (with the c streams stored if ``store_c``: the train step's
    launch) and K2 at T=1900, B rows and width H, each timed and checked
    beside its plain version."""
    from mgr_tpu_torch.kernels.bilstm_tm import bilstm_tm_bwd, bilstm_tm_streams
    from mgr_tpu_torch.ops.lstm import (
        bilstm_scan_tm_bwd_plain, bilstm_scan_tm_plain, recurrent_weight_grad)

    xp, U, dhs = _lstm_inputs(dev, (T_K1, B), H)
    bwd = (xp[0], xp[1], U, *bilstm_tm_streams(xp[0], xp[1], U, store_c=True), dhs[0], dhs[1])
    return {
        "bilstm_tm_fwd": _timing(
            lambda: bilstm_tm_streams(xp[0], xp[1], U, store_c=store_c),
            lambda: bilstm_scan_tm_plain(xp[0], xp[1], U, store_c=store_c),
            lstm_bound(T_K1, B, H, dirs=2, backward=False, store_c=store_c),
            f"K1 at B={B}, H={H}", _streams_check),
        "bilstm_tm_bwd": _timing(
            lambda: bilstm_tm_bwd(*bwd), lambda: bilstm_scan_tm_bwd_plain(*bwd),
            lstm_bound(T_K1, B, H, dirs=2, backward=True, store_c=False), f"K2 at B={B}, H={H}",
            lambda what, got, want: _dz_check(
                what, got, want[:2], recurrent_weight_grad(bwd[3], bwd[4], *got),
                want[2], fro=False)),
    }


def fusion_kernels_phase(dev) -> dict:
    """K1-K4 at the shapes the fusion path gives them and no other phase
    does: K1 (without the c store: the frozen encoders' launch) and K2 at
    H=100 (13 eight-unit slices, the last half empty), T=1900, B=32;
    K3/K4 at the fusion presets' K=22, N=35 (T'=1898, B=32)."""
    out = _bilstm_at(dev, B_K2, H_FUS, store_c=False)
    out.update(_ctc_at_shape(dev, SEED + 30, B_K2, K_FUS, N_FUS))
    phase("fusion_kernels", T=T_K1, B=B_K2, H=H_FUS, K=K_FUS, N=N_FUS, kernels=out)
    return out


def rgb_kernels_phase(dev) -> dict:
    """K1-K4 at the shapes the rgb family gives them: K1 (c stored) and K2
    at H=512 (MAX_H: 64 eight-unit slices a direction, every warp's K
    slice full), T=1900, at the preset's B=8 and at B=256 (K2's largest
    shared-memory opt-in); K3/K4 at K=22, N=28 (T'=1898, B=8)."""
    out = _bilstm_at(dev, B_RGB, H_RGB, store_c=True)
    edge = _bilstm_at(dev, B_RGB_EDGE, H_RGB, store_c=True)
    torch.cuda.empty_cache()
    out.update(_ctc_at_shape(dev, SEED + 41, B_RGB, K_RGB, N_RGB))
    phase("rgb_kernels", T=T_K1, H=H_RGB, B=B_RGB, K=K_RGB, N=N_RGB, kernels=out,
          at_B256=edge)
    return out


def k5_phase(dev) -> dict:
    """K5a and K5b, the single-direction recurrence and its adjoint (the
    forward scan order), at T=1900, H=500 and B_K5, and at the shapes the
    2x2 meshes of every family give them (K5_FAM_SHAPES), each timed and
    checked beside its plain version."""
    from mgr_tpu_torch.kernels.bilstm_tm import lstm_tm_bwd, lstm_tm_streams
    from mgr_tpu_torch.ops.lstm import (
        lstm_scan_tm_bwd_plain, lstm_scan_tm_plain, lstm_weight_grad)

    def at(B, H):
        xp, U, dhs = _lstm_inputs(dev, (T_K1, B), H, dirs=1)
        fwd = (xp[0], U[0])
        bwd = (*fwd, *lstm_tm_streams(*fwd, reverse=False, store_c=True), dhs[0])
        return {
            "lstm_tm_fwd": _timing(
                lambda: lstm_tm_streams(*fwd, reverse=False, store_c=True),
                lambda: lstm_scan_tm_plain(*fwd, reverse=False, store_c=True),
                lstm_bound(T_K1, B, H, dirs=1, backward=False, store_c=True),
                f"K5a at B={B}, H={H}", _streams_check),
            "lstm_tm_bwd": _timing(
                lambda: lstm_tm_bwd(*bwd, reverse=False),
                lambda: lstm_scan_tm_bwd_plain(*bwd, reverse=False),
                lstm_bound(T_K1, B, H, dirs=1, backward=True, store_c=False),
                f"K5b at B={B}, H={H}", lambda what, got, want: _dz_check(
                    what, [got], want[:1],
                    lstm_weight_grad(bwd[2], got, reverse=False), want[1], fro=True)),
        }

    speech = {f"B={B}": at(B, H_K1) for B in B_K5}
    family = {f"B={B} H={H}": at(B, H) for B, H in K5_FAM_SHAPES}
    phase("k5_lstm_tm", T=T_K1, H=H_K1, times=speech, at_family_shapes=family)
    return {name: {**speech[f"B={B_K5[0]}"][name], "library_ms": None,
                   "at_family_shapes": {shape: t[name] for shape, t in family.items()}}
            for name in ("lstm_tm_fwd", "lstm_tm_bwd")}


def k6_phase(dev) -> dict:
    """K6a and K6b, the batch-major scan of both directions and its
    adjoint, at T=1900, H=500 and B_K6, each timed and checked beside its
    plain version."""
    from mgr_tpu_torch.kernels.lstm_scan import lstm_scan_bwd, lstm_scan_streams
    from mgr_tpu_torch.ops.lstm import (
        recurrent_scan_bwd_plain, recurrent_scan_plain, scan_weight_grad)

    times = {}
    for B in B_K6:
        xp, U, dhs = _lstm_inputs(dev, (B, T_K1), H_K1)
        bwd = (xp, U, *lstm_scan_streams(xp, U, store_c=True), dhs)
        times[f"B={B}"] = {
            "lstm_scan_fwd": _timing(
                lambda: lstm_scan_streams(xp, U, store_c=True),
                lambda: recurrent_scan_plain(xp, U, store_c=True),
                lstm_bound(T_K1, B, H_K1, dirs=2, backward=False, store_c=True),
                f"K6a at B={B}", _streams_check, reps=3),
            "lstm_scan_bwd": _timing(
                lambda: lstm_scan_bwd(*bwd), lambda: recurrent_scan_bwd_plain(*bwd),
                lstm_bound(T_K1, B, H_K1, dirs=2, backward=True, store_c=False),
                f"K6b at B={B}", lambda what, got, want: _dz_check(
                    what, [got], [want], scan_weight_grad(bwd[2], got),
                    scan_weight_grad(bwd[2], want), fro=True), reps=3),
        }
    phase("k6_lstm_scan", T=T_K1, H=H_K1, D=2, times=times)
    return {name: {**times[f"B={B_K6[0]}"][name], "library_ms": None}
            for name in ("lstm_scan_fwd", "lstm_scan_bwd")}


def bm_path_phase(dev) -> dict:
    """The batch-major layer API as a user calls it, at the speech
    encoder's width (bf16): a train-mode stack of two ``bilstm_layer``s
    (F=39 -> 1000 -> 1000, input dropout 0.4 / 0.5, B=32, T=1900) and an
    ``lstm_layer(reverse=True)`` on its output, forward and backward,
    counted (K6a/K6b and no other kernel). Checks: each layer's
    eval-mode output against ``bilstm_layer_tm`` (K1) on the same
    parameters and input; the train-mode outputs and gradients against
    the same stack with K6a/K6b's plain versions on the card (same masks:
    the draws depend on the key only)."""
    from mgr_tpu_torch.core import prng
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.ops import lstm as lstm_lib

    cfg = get_preset("speech")
    T, F, H, B = cfg.maxlen, cfg.num_feats, cfg.encoder.hidden, cfg.batch_size
    rates = cfg.encoder.dropout
    gen = torch.Generator().manual_seed(SEED + 14)
    dgen = torch.Generator(dev).manual_seed(SEED + 14)
    stack = [lstm_lib.init_bilstm_params(gen, F, H), lstm_lib.init_bilstm_params(gen, 2 * H, H)]
    stack = [{k: v.to(dev).requires_grad_() for k, v in p.items()} for p in stack]
    one = {k: v.to(dev).requires_grad_()
           for k, v in lstm_lib.init_lstm_params(gen, 2 * H, H).items()}
    leaves = [v for p in stack + [one] for v in p.values()]
    x = torch.randn((B, T, F), generator=dgen, device=dev)
    tangent = torch.randn((B, T, 2 * H), generator=dgen, device=dev)
    tangent1 = torch.randn((B, T, H), generator=dgen, device=dev)
    key = prng.fold_name(prng.root_key(SEED), "bm_path")

    def run():
        h = x
        for i, p in enumerate(stack):
            h = lstm_lib.bilstm_layer(p, h, rng=prng.fold_in(key, i), dropout=rates[i],
                                      train=True)
        r = lstm_lib.lstm_layer(one, h, reverse=True)
        loss = (h.float() * tangent).sum() + (r.float() * tangent1).sum()
        return h.detach(), r.detach(), torch.autograd.grad(loss, leaves)

    dispatch.reset_launch_counts()
    h_k, r_k, grads_k = run()
    launches = dispatch.launch_counts()
    want = {name: 3 if name.startswith("lstm_scan") else 0 for name in KERNELS}
    if launches != want:
        raise AssertionError(f"the batch-major path took the wrong kernels: {launches}")

    with plain_path():
        h_p, r_p, grads_p = run()
    out_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in ((h_k, h_p), (r_k, r_p)))
    grad_rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(grads_k, grads_p)]

    with torch.no_grad():  # eval mode, layer by layer, against K1
        h, tm_err = x, 0.0
        for p in stack:
            bm = lstm_lib.bilstm_layer(p, h)
            tm = lstm_lib.bilstm_layer_tm(p, h.transpose(0, 1)).transpose(0, 1)
            tm_err = max(tm_err, float((bm.float() - tm.float()).abs().max()))
            h = bm
    if not (torch.isfinite(h_k.float()).all() and torch.isfinite(r_k.float()).all()) or \
            h_k.shape != (B, T, 2 * H) or r_k.shape != (B, T, H):
        raise AssertionError(f"bad outputs {tuple(h_k.shape)}, {tuple(r_k.shape)}")
    if tm_err > TOL_K1_H or out_err > TOL_K1_H or max(grad_rel) > TOL_GRAD_REL:
        raise AssertionError(
            f"the batch-major path disagrees: eval vs bilstm_layer_tm {tm_err}, train outputs "
            f"vs plain {out_err} (tol {TOL_K1_H}), gradients vs plain {grad_rel} "
            f"(tol {TOL_GRAD_REL})")
    phase("bm_path", B=B, T=T, F=F, H=H, layers="bilstm_layer x2 (train, dropout "
          f"{list(rates)}) + lstm_layer(reverse=True)", launches=launches,
          eval_vs_k1_max_abs_err=tm_err, train_out_vs_plain_max_abs_err=out_err, tol_out=TOL_K1_H,
          grad_max_rel_err=max(grad_rel), tol_grad_rel=TOL_GRAD_REL)
    return launches


def _digest(model) -> str:
    return _digest_tensors(model.parameters())


def _digest_tensors(tensors) -> str:
    return hashlib.sha256(b"".join(
        p.detach().float().cpu().numpy().tobytes() for p in tensors)).hexdigest()


def _mesh_rank(rank, world, shape, cfg_json, batch, corpus, workdir):
    """One rank of a (data, model) mesh on the one card: the mesh step's
    loss and gradients and the mesh eval loss with the launch counts of
    that run, and with a corpus one epoch of fit over the mesh."""
    from mgr_tpu_torch.core.config import MeshConfig, PipelineConfig
    from mgr_tpu_torch.data.batcher import Batcher
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.parallel.mesh import make_mesh
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.loop import fit

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig.from_json(cfg_json)
    mesh = make_mesh(MeshConfig(*shape), device="cuda:0")
    model = build_model(cfg, seed=SEED, device=mesh.device)
    dispatch.reset_launch_counts()
    loss, grads = step_lib.mesh_loss_and_grads(
        model, mesh, dict(model.named_parameters()), batch, None)
    ev = step_lib.make_eval_step(model, mesh=mesh)(batch)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "eval": float(ev), "launches": dispatch.launch_counts()}
    if rank == 0:
        out["grads"] = {k: g.float().cpu().numpy() for k, g in grads.items()}
    del grads
    if corpus is not None:
        feats, labels, lab_len, in_len, ids, n_train = corpus
        data = Batcher(feats, labels, lab_len, in_len, ids,
                       train_ids=ids[:n_train], val_ids=ids[n_train:])
        fresh = build_model(cfg, seed=SEED, device=mesh.device)
        res = fit(fresh, data, workdir=workdir, epochs=1, mesh=mesh)
        out["fit"] = {"digest": _digest(fresh), "epochs_run": res.epochs_run,
                      "history": [{k: h[k] for k in ("train_loss", "val_loss")}
                                  for h in res.history]}
    return out


def mesh_phase(dev) -> dict:
    """The mesh slice at full speech width (B=32, T=1900, H=500, noise and
    dropout off, bf16): on 2x1 (DP), 1x2 (direction-sharded TP) and 2x2
    meshes of gloo ranks that time-share the one card, one mesh train step
    (loss and every raw gradient) and one mesh eval step held against the
    single-process kernel step on the same batch; each rank's launch
    counts (K5a/K5b and no K1/K2 under model=2, K1/K2 under 2x1); one
    epoch of fit over the 2x2 mesh (the primary writes the best slot,
    every rank ends on the same parameters, the slot reloads in this
    process and decodes)."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.data.batcher import Batcher
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.parallel.spawn import run_ranks
    from mgr_tpu_torch.train import step as step_lib

    cfg = get_preset("speech")
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0))
    B = cfg.batch_size
    feats, labels, lab_len, in_len = _speech_corpus(cfg, B, SEED + 10)
    batch = {"inputs": feats, "labels": labels, "input_length": in_len, "label_length": lab_len}
    model = build_model(cfg, seed=SEED, device=dev)
    tb = {k: step_lib.to_device(batch[k], dev) for k in step_lib.BATCH_KEYS}
    loss_1, grads_1 = step_lib._loss_and_grads(model, dict(model.named_parameters()), tb, None)
    loss_1 = float(loss_1)
    grads_1 = {k: g.float().cpu() for k, g in grads_1.items()}
    eval_1 = float(step_lib.make_eval_step(model)(batch))
    del model, tb
    torch.cuda.empty_cache()
    n = N_MESH_TRAIN + N_MESH_VAL
    corpus = (*_speech_corpus(cfg, n, SEED + 11), list(range(1, n + 1)), N_MESH_TRAIN)

    meshes = {}
    with tempfile.TemporaryDirectory() as workdir:
        for shape in MESHES:
            out = run_ranks(_mesh_rank, shape[0] * shape[1],
                            (shape, cfg.to_json(), batch,
                             corpus if shape == (2, 2) else None, workdir),
                            timeout_s=MESH_TIMEOUT_S)
            grads = out[0]["grads"]
            grad_rel = {k: float(np.linalg.norm(grads[k] - g.numpy())
                                 / max(float(g.norm()), 1e-30)) for k, g in grads_1.items()}
            loss_rel = max(abs(r["loss"] - loss_1) / abs(loss_1) for r in out)
            eval_rel = max(abs(r["eval"] - eval_1) / abs(eval_1) for r in out)
            if loss_rel > TOL_LOSS_REL or eval_rel > TOL_LOSS_REL or \
                    max(grad_rel.values()) > TOL_GRAD_REL:
                raise AssertionError(
                    f"mesh {shape} disagrees with the single-process step: loss rel "
                    f"{loss_rel}, eval rel {eval_rel} (tol {TOL_LOSS_REL}), grads {grad_rel} "
                    f"(tol {TOL_GRAD_REL})")
            tp = shape[1] == 2
            for r in out:
                c = r["launches"]
                one = c["lstm_tm_fwd"] > 0 and c["lstm_tm_bwd"] > 0
                two = c["bilstm_tm_fwd"] > 0 or c["bilstm_tm_bwd"] > 0
                both_ctc = c["ctc_fwd"] > 0 and c["ctc_bwd"] > 0
                ok = (one and not two) if tp else (not c["lstm_tm_fwd"] and
                                                     not c["lstm_tm_bwd"] and
                                                     c["bilstm_tm_fwd"] > 0 and
                                                     c["bilstm_tm_bwd"] > 0)
                if not (ok and both_ctc):
                    raise AssertionError(f"mesh {shape}: a rank took the wrong kernels: {c}")
            name = "x".join(map(str, shape))
            meshes[name] = {
                "loss_rel_err": loss_rel, "eval_rel_err": eval_rel,
                "grad_max_rel_err": max(grad_rel.values()),
                "launches_rank0": out[0]["launches"],
            }
            if shape == (2, 2):
                fits = [r["fit"] for r in out]
                if len({f["digest"] for f in fits}) != 1 or fits[0]["epochs_run"] != 1:
                    raise AssertionError(f"the 2x2 fit's ranks disagree: {fits}")
                fresh = build_model(cfg, seed=SEED + 99, device=dev)
                ckpt_lib.load_params(workdir, "speech", fresh, slot="best")
                data = Batcher(*corpus[:5], train_ids=corpus[4][:N_MESH_TRAIN],
                               val_ids=corpus[4][N_MESH_TRAIN:])
                decoded = Decoder.for_model(fresh, "speech").decode_batches(
                    [next(iter(data.epoch(B, train=False)))])
                if len(decoded) != B or _digest(fresh) != fits[0]["digest"]:
                    raise AssertionError("the 2x2 fit's best slot does not reload and decode")
                meshes[name]["fit"] = {"history": fits[0]["history"], "slot_reloads": True,
                                       "ranks_agree": True}
    phase("mesh", pipeline="speech", B=B, T=cfg.maxlen, H=cfg.encoder.hidden, backend="gloo",
          ranks_share_one_card=True, loss_1=loss_1, eval_1=eval_1, tol_loss_rel=TOL_LOSS_REL,
          tol_grad_rel=TOL_GRAD_REL, meshes=meshes)
    return meshes["2x2"]["launches_rank0"]


def _families_cfgs():
    """Each family's preset at full width with noise and dropout off (the
    mesh step is held against the single-process step on the same batch,
    without draws); speech and skeletal are also late fusion's sources."""
    from mgr_tpu_torch.core.config import get_preset

    def quiet(name, **kw):
        cfg = get_preset(name)
        enc = dataclasses.replace(cfg.encoder, input_noise=0.0, output_dropout=0.0,
                                  dropout=tuple(0.0 for _ in cfg.encoder.dropout))
        return cfg.replace(encoder=enc, **kw)

    return {"speech": quiet("speech"), "skeletal": quiet("skeletal"),
            "early_fusion": quiet("early_fusion", second_stream_noise=0.0),
            "late_fusion": quiet("late_fusion", fusion_dropout=0.0, fusion_output_dropout=0.0),
            "rgb": quiet("rgb")}


def _family_batch(cfg, B, seed):
    """B seeded rows of ``cfg``'s family: one stream, two, or video."""
    if cfg.name == "rgb":
        return _video_batch(cfg, B, seed)
    if cfg.second_stream_feats:
        (a, s), labels, lab_len, in_len = _two_stream_corpus(cfg, B, seed)
        streams = {"inputs": a, "inputs2": s}
    else:
        feats, labels, lab_len, in_len = _speech_corpus(cfg, B, seed)
        streams = {"inputs": feats}
    return {**streams, "labels": labels, "label_length": lab_len, "input_length": in_len}


def _family_model(name, cfgs, dev):
    """``name``'s model from SEED, its weights drawn with one CPU thread as
    a rank (``run_ranks``) draws them: the orthogonal init's QR differs in
    its last bits with the thread count."""
    from mgr_tpu_torch.models.zoo import build_model

    sources = {k: cfgs[k] for k in ("speech", "skeletal")} if name == "late_fusion" else None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return build_model(cfgs[name], sources, seed=SEED, device=dev)
    finally:
        torch.set_num_threads(threads)


def _families_rank(rank, world, device, shape, cfgs_json, train, decode, curriculum_dir):
    """One rank of a (data, model) mesh on the one card, every family of the
    launch in turn: for each trained family one mesh step's loss and raw
    gradients and one mesh eval step with the launch counts of that run,
    and whether the frozen parameters stayed bit-unchanged through one
    mesh train step; for each decoded family the mesh decode
    (``Decoder.for_model(mesh=)``) of its global batch; with a
    ``curriculum_dir`` ``run_curriculum(mesh=)``, one epoch a stage on the
    fusion phase's corpora: the stamps this rank wrote and a digest of
    each stage's final parameters."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.core.config import MeshConfig, PipelineConfig, get_preset
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.parallel import sharding as shard_lib
    from mgr_tpu_torch.parallel.mesh import make_mesh
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.curriculum import run_curriculum

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = {k: PipelineConfig.from_json(v) for k, v in cfgs_json.items()}
    mesh = make_mesh(MeshConfig(*shape), device=device)
    out = {"train": {}, "decode": {}}
    for name in train:
        cfg = cfgs[name]
        batch = _family_batch(cfg, cfg.batch_size, SEED + FAM_SEED[name])
        model = _family_model(name, cfgs, mesh.device)
        trainable = model.trainable()
        frozen = {k: p.detach().clone() for k, p in model.named_parameters() if not trainable[k]}
        dispatch.reset_launch_counts()
        loss, grads = step_lib.mesh_loss_and_grads(
            model, mesh, dict(model.named_parameters()), batch, None)
        ev = step_lib.make_eval_step(model, mesh=mesh)(batch)
        torch.cuda.synchronize()
        r = {"loss": float(loss), "eval": float(ev), "launches": dispatch.launch_counts()}
        if rank == 0:
            r["grads"] = {k: g.float().cpu().numpy() for k, g in grads.items()}
        del grads
        state = step_lib.create_train_state(model)
        train_step = step_lib.make_train_step(model, mesh=mesh)
        state, m = train_step(state, batch, None)
        float(m["loss"])
        r["frozen"] = len(frozen)
        r["frozen_unchanged"] = all(torch.equal(p, frozen[k])
                                    for k, p in model.named_parameters() if k in frozen)
        out["train"][name] = r
        del model, state, train_step
        torch.cuda.empty_cache()
    for name in decode:
        batch = _family_batch(cfgs[name], FAM_DECODE[name], SEED + FAM_SEED[name] + 10)
        model = _family_model(name, cfgs, mesh.device)
        dec = Decoder.for_model(model, name, mesh=mesh)
        dispatch.reset_launch_counts()
        best, emit = dec.decode_fn(step_lib.batch_inputs(batch), None)
        torch.cuda.synchronize()
        out["decode"][name] = {"best": best.cpu().numpy(), "emit": emit.cpu().numpy(),
                               "launches": dispatch.launch_counts()}
        rows = shard_lib.shard_batch(batch, mesh)  # this rank's posteriors (every rank
        with step_lib._shard_context(mesh):        # joins the exchanges)
            probs = step_lib.make_predict_step(model)(step_lib.batch_inputs(rows))
        if rank == 0:
            out["decode"][name]["probs"] = probs.float().cpu().numpy()
        del model, dec
        torch.cuda.empty_cache()
    if curriculum_dir:
        writes, real = [], ckpt_lib.save_train_state

        def spy(workdir, stamp, *a, **kw):
            writes.append(stamp)
            return real(workdir, stamp, *a, **kw)

        ckpt_lib.save_train_state = spy
        presets = {k: get_preset(k) for k in ("speech", "skeletal", "late_fusion")}
        n = N_FUS_TRAIN + N_FUS_VAL
        data = [_batcher(_speech_corpus(presets[k], n, SEED + 22 + i), N_FUS_TRAIN)
                for i, k in enumerate(("speech", "skeletal"))]
        data.append(_batcher(_two_stream_corpus(presets["late_fusion"], n, SEED + 21),
                             N_FUS_TRAIN))
        dispatch.reset_launch_counts()
        res = run_curriculum(*data, curriculum_dir, configs=presets, mesh=mesh, epochs=1)
        out["curriculum"] = {
            "writes": sorted(set(writes)), "launches": dispatch.launch_counts(),
            "stages": {k: {"digest": _digest_tensors(r.state.params.values()),
                           "epochs_run": r.epochs_run,
                           "history": [{h_k: h[h_k] for h_k in ("train_loss", "val_loss")}
                                       for h in r.history]} for k, r in res.items()}}
    return out


def _decode_agrees(got, want, probs, rank0_probs) -> dict:
    """A mesh decode's (best, emit) against the single-process one on the
    same rows, in global row order: equal in every frame. Each rank's
    launches have the single-process decode's shapes (K5a is bit-equal to
    K1's direction, the exchange adds zeros), and both sides' weights are
    drawn with one thread, so the posteriors are the same bits and no
    argmax may flip; a row gathered out of order differs too."""
    (best, emit), (best_1, emit_1) = got, want
    differ = (best != best_1) | (emit != emit_1)
    half = rank0_probs.shape[0]
    probs_diff = float(np.abs(rank0_probs[:, -probs.shape[1]:] - probs[:half]).max())
    if differ.any():
        raise AssertionError(
            f"mesh decode differs from one process in rows "
            f"{np.nonzero(differ.any(1))[0].tolist()} ({int(differ.sum())} of {differ.size} "
            f"frames; rank 0's posteriors {probs_diff} apart)")
    return {"rows": int(best.shape[0]), "rows_equal": int(best.shape[0]),
            "frames": int(best.size), "rank0_probs_max_abs_diff": probs_diff}


def mesh_families_phase(dev) -> dict:
    """Every family over meshes of gloo ranks that time-share the one card,
    at full width (B=32, T=1900; rgb B=8, 60x60 frames), bf16, noise and
    dropout off: early fusion (BiLSTM(500)x2 over 39+20 features), late
    fusion (frozen speech H=500 and skeletal H=300 encoders, the fusion
    BiLSTM(100)) and rgb (the CNN with remat, BiLSTM(512)x2) on 2x2, and
    rgb on 2x1. For each, one mesh train step's loss and every raw gradient
    and one mesh eval loss against the single-process step on the same
    batch; each rank's launches (K5a/K5b and no K1/K2 on 2x2, K1/K2 on 2x1,
    K3/K4 always); late fusion's encoders bit-unchanged through a mesh
    train step. Then speech (B=128) and late fusion (B=32) decoded over
    both meshes against the single-process decode of the same rows, and
    ``run_curriculum(mesh=)`` on 2x1 (one epoch a stage: rank 0 alone
    writes, the ranks end equal, the fusion slot's encoders are the
    donors' best slots)."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.decode.decoder import DECODE_SPECS
    from mgr_tpu_torch.parallel.spawn import run_ranks
    from mgr_tpu_torch.train import step as step_lib

    cfgs = _families_cfgs()
    refs = {}
    for name in FAM_TRAIN[(2, 2)]:
        cfg = cfgs[name]
        batch = _family_batch(cfg, cfg.batch_size, SEED + FAM_SEED[name])
        model = _family_model(name, cfgs, dev)
        tb = step_lib.batch_to_device(batch, dev)
        loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), tb, None)
        refs[name] = {"loss": float(loss), "eval": float(step_lib.make_eval_step(model)(batch)),
                      "grads": {k: g.float().cpu() for k, g in grads.items()}}
        del model, tb, grads
        torch.cuda.empty_cache()
    dec_refs = {}
    for name, B in FAM_DECODE.items():
        spec = DECODE_SPECS[name]
        batch = _family_batch(cfgs[name], B, SEED + FAM_SEED[name] + 10)
        model = _family_model(name, cfgs, dev)
        decode = step_lib.make_decode_step(model, threshold=spec.threshold,
                                           trim_frames=spec.trim_frames)
        predict = step_lib.make_predict_step(model)
        halves = []  # the rows of each data index, decoded at a rank's shape
        for d in range(2):
            rows = {k: v[d * B // 2:(d + 1) * B // 2] for k, v in batch.items()}
            inputs = step_lib.batch_inputs(rows)
            best, emit = decode(inputs, None)
            halves.append((best.cpu().numpy(), emit.cpu().numpy(),
                           predict(inputs)[:, spec.trim_frames:].float().cpu().numpy()))
        dec_refs[name] = tuple(np.concatenate(parts) for parts in zip(*halves))
        del model
        torch.cuda.empty_cache()

    cfgs_json = {k: v.to_json() for k, v in cfgs.items()}
    meshes, decodes, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as cur_dir:
        for shape in FAM_MESHES:
            mname = "x".join(map(str, shape))
            out = run_ranks(_families_rank, shape[0] * shape[1],
                            (str(dev), shape, cfgs_json, FAM_TRAIN[shape], tuple(FAM_DECODE),
                             cur_dir if shape == (2, 1) else None),
                            timeout_s=MESH_TIMEOUT_S)
            tp = shape[1] == 2
            for name in FAM_TRAIN[shape]:
                ref, res = refs[name], [r["train"][name] for r in out]
                grads = res[0]["grads"]
                grad_rel = {k: float(np.linalg.norm(grads[k] - g.numpy())
                                     / max(float(g.norm()), 1e-30))
                            for k, g in ref["grads"].items() if float(g.norm()) > 0}
                frozen_zero = all(not grads[k].any() for k, g in ref["grads"].items()
                                  if float(g.norm()) == 0)
                loss_rel = max(abs(r["loss"] - ref["loss"]) / abs(ref["loss"]) for r in res)
                eval_rel = max(abs(r["eval"] - ref["eval"]) / abs(ref["eval"]) for r in res)
                if loss_rel > TOL_LOSS_REL or eval_rel > TOL_LOSS_REL or not frozen_zero or \
                        max(grad_rel.values()) > TOL_GRAD_REL:
                    raise AssertionError(
                        f"{name} on {mname} disagrees with the single-process step: loss rel "
                        f"{loss_rel}, eval rel {eval_rel} (tol {TOL_LOSS_REL}), grads "
                        f"{grad_rel} (tol {TOL_GRAD_REL}), frozen grads zero {frozen_zero}")
                for r in res:
                    c = r["launches"]
                    one = c["lstm_tm_fwd"] > 0 and c["lstm_tm_bwd"] > 0
                    two = c["bilstm_tm_fwd"] > 0 and c["bilstm_tm_bwd"] > 0
                    ok = (one and not c["bilstm_tm_fwd"] and not c["bilstm_tm_bwd"]) if tp \
                        else (two and not c["lstm_tm_fwd"] and not c["lstm_tm_bwd"])
                    if not (ok and c["ctc_fwd"] > 0 and c["ctc_bwd"] > 0):
                        raise AssertionError(f"{name} on {mname}: a rank took the wrong "
                                             f"kernels: {c}")
                    if not r["frozen_unchanged"] or (name == "late_fusion") != (r["frozen"] > 0):
                        raise AssertionError(f"{name} on {mname}: frozen parameters "
                                             f"{r['frozen']}, unchanged {r['frozen_unchanged']}")
                launches[f"{name} {mname}"] = res[0]["launches"]
                meshes[f"{name} {mname}"] = {
                    "loss_rel_err": loss_rel, "eval_rel_err": eval_rel,
                    "grad_max_rel_err": max(grad_rel.values()),
                    "launches_rank0": res[0]["launches"],
                    **({"frozen_encoders_bit_unchanged": True} if name == "late_fusion" else {}),
                }
            for name in FAM_DECODE:
                res = [r["decode"][name] for r in out]
                if any(not (np.array_equal(r["best"], res[0]["best"])
                            and np.array_equal(r["emit"], res[0]["emit"])) for r in res):
                    raise AssertionError(f"decode {name} on {mname}: the ranks disagree")
                best_1, emit_1, probs = dec_refs[name]
                decodes[f"{name} {mname}"] = _decode_agrees(
                    (res[0]["best"], res[0]["emit"]), (best_1, emit_1), probs,
                    res[0]["probs"])
                launches[f"decode {name} {mname}"] = res[0]["launches"]
            if shape == (2, 1):
                cur = [r["curriculum"] for r in out]
                stages = ("speech", "skeletal", "late_fusion")
                if cur[0]["writes"] != sorted(stages) or cur[1]["writes"]:
                    raise AssertionError(f"curriculum: writes {[c['writes'] for c in cur]}")
                for k in stages:
                    if cur[0]["stages"][k]["digest"] != cur[1]["stages"][k]["digest"] or \
                            cur[0]["stages"][k]["epochs_run"] != 1:
                        raise AssertionError(f"curriculum stage {k}: the ranks disagree")
                fused = ckpt_lib.read_params(cur_dir, "late_fusion")
                for k in ("speech", "skeletal"):
                    for key, v in ckpt_lib.read_params(cur_dir, k).items():
                        if key.startswith("encoder.") and not torch.equal(
                                fused[f"{k}.{key[len('encoder.'):]}"], v):
                            raise AssertionError(f"curriculum: fusion slot's {k}.{key} is "
                                                 f"not the donor's best slot")
                launches["curriculum 2x1"] = cur[0]["launches"]
                curriculum = {"launches_rank0": cur[0]["launches"],
                              "history": {k: v["history"] for k, v in cur[0]["stages"].items()},
                              "rank0_alone_writes": True, "ranks_agree": True,
                              "fusion_encoders_are_the_donors": True}
    phase("mesh_families", backend="gloo", ranks_share_one_card=True,
          tol_loss_rel=TOL_LOSS_REL, tol_grad_rel=TOL_GRAD_REL, steps=meshes,
          decodes=decodes, curriculum=curriculum)
    return launches


def _gspmd_key():
    from mgr_tpu_torch.core import prng

    return prng.fold_in(prng.fold_name(prng.root_key(SEED), "dropout"), 0)


def _gspmd_cfgs():
    """Speech's preset at full width, noise and dropout on; and the
    families' (late fusion over speech and skeletal sources), every encoder
    cut to ``GSPMD_FAM_DEPTH`` layers."""
    from mgr_tpu_torch.core.config import get_preset

    def cut(name):
        cfg = get_preset(name)
        return cfg.replace(encoder=dataclasses.replace(cfg.encoder, depth=GSPMD_FAM_DEPTH))

    fams = {k: cut(k) for k in ("speech", "skeletal", "early_fusion", "late_fusion", "rgb")}
    return get_preset("speech"), fams


def _gspmd_rank(rank, world, device, shape, speech_json, fams_json, families, fit_dir):
    """One rank of a (data, model, time) mesh of the GSPMD route on the one
    card: one speech mesh train step and one of each of ``families`` (the
    raw loss and gradients the optimizer gets, the launches and all-reduces,
    and whether the frozen parameters stayed unchanged); with ``fit_dir``
    one epoch of speech over the mesh (rank 0 writes the slots) and, on
    rank 0, the one-process decode of a batch with the in-memory
    parameters."""
    import torch.distributed as dist

    from mgr_tpu_torch.core.config import MeshConfig, PipelineConfig
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.parallel.mesh import make_mesh
    from mgr_tpu_torch.train import step as step_lib
    from mgr_tpu_torch.train.loop import fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    speech_cfg = PipelineConfig.from_json(speech_json)
    fams = {k: PipelineConfig.from_json(v) for k, v in fams_json.items()}
    mesh = make_mesh(MeshConfig(*shape), device=device)
    key = _gspmd_key()
    reduces, real_all_reduce = [0], dist.all_reduce

    def counted(*a, **kw):
        reduces[0] += 1
        return real_all_reduce(*a, **kw)

    dist.all_reduce = counted
    seen, real_apply = {}, step_lib._apply_updates

    def capture(model, state, tx, loss, grads, lr_scale):
        """The combined loss and gradients the optimizer tail gets."""
        seen["loss"] = float(loss)
        if rank == 0:
            seen["grads"] = {k: g.float().cpu().numpy() for k, g in grads.items()}
        return real_apply(model, state, tx, loss, grads, lr_scale)

    step_lib._apply_updates = capture

    def train_step(name, cfgs, B):
        batch = _family_batch(cfgs[name], B, SEED + FAM_SEED[name] + 20)
        model = _family_model(name, cfgs, mesh.device)
        trainable = model.trainable()
        frozen = {k: p.detach().clone() for k, p in model.named_parameters() if not trainable[k]}
        state = step_lib.create_train_state(model)
        dispatch.reset_launch_counts()
        n0 = reduces[0]
        state, m = step_lib.make_train_step(model, mesh=mesh)(state, batch, key)
        float(m["loss"])
        r = {"launches": dispatch.launch_counts(), "all_reduces": reduces[0] - n0, **seen}
        r["frozen"] = len(frozen)
        r["frozen_unchanged"] = all(torch.equal(p, frozen[k])
                                    for k, p in model.named_parameters() if k in frozen)
        del model, state
        torch.cuda.empty_cache()
        return r

    out = {"speech": train_step("speech", {"speech": speech_cfg}, GSPMD_B),
           "families": {name: train_step(name, fams, GSPMD_FAM_B) for name in families}}
    step_lib._apply_updates = real_apply
    if fit_dir:
        cfgs = {"speech": speech_cfg.replace(batch_size=GSPMD_B)}
        corpus = _speech_corpus(cfgs["speech"], N_GSPMD_TRAIN + N_GSPMD_VAL, SEED + 70)
        model = _family_model("speech", cfgs, mesh.device)
        dispatch.reset_launch_counts()
        res = fit(model, _batcher(corpus, N_GSPMD_TRAIN), workdir=fit_dir, epochs=1, mesh=mesh)
        out["fit"] = {"digest": _digest(model), "epochs_run": res.epochs_run,
                      "launches": dispatch.launch_counts(),
                      "history": [{k: h[k] for k in ("train_loss", "val_loss")}
                                  for h in res.history]}
        if rank == 0:
            best, emit = Decoder.for_model(model, "speech").decode_fn(corpus[0][:GSPMD_B], None)
            out["fit"]["decode"] = (best.cpu().numpy(), emit.cpu().numpy())
    return out


def gspmd_phase(dev) -> dict:
    """The GSPMD route on gloo ranks that time-share the one card: speech at
    full width (B=8, T=1900, BiLSTM(500)x2, bf16) with noise 0.5 and
    dropout on, the same key, on 1x4 (H-blocks of 125: the H-sharded
    recurrence, one exchange a time step, no K1/K2), 2x1x2 (time slices of
    950, the recurrence whole through K1/K2 on every rank) and 1x2x2 (H over
    2 and time, not the direction-sharded route). On each mesh one train
    step: its loss and every combined gradient against the single-process
    step on the card with the same draws, its launches on each rank (K1/K2
    0 on 1x4 and 1x2x2, K3/K4 on every rank) and its all-reduces. Early
    fusion, late fusion (frozen encoders) and rgb, their encoders at depth
    1, one step each on 1x4 at B=2 against their single-process step.
    ``fit`` of one epoch of speech over 1x2x2 with a workdir: this process
    reads the best slot and decodes, bit for bit the decode of rank 0's
    in-memory parameters."""
    from mgr_tpu_torch.core import checkpoint as ckpt_lib
    from mgr_tpu_torch.decode.decoder import Decoder
    from mgr_tpu_torch.parallel.spawn import run_ranks
    from mgr_tpu_torch.train import optimizer as opt_lib
    from mgr_tpu_torch.train import step as step_lib

    speech, fams = _gspmd_cfgs()
    key = _gspmd_key()
    refs = {}
    for name, cfgs, B in (("speech", {"speech": speech}, GSPMD_B),
                          *((n, fams, GSPMD_FAM_B) for n in FAM_TRAIN[(2, 2)])):
        batch = _family_batch(cfgs[name], B, SEED + FAM_SEED[name] + 20)
        model = _family_model(name, cfgs, dev)
        tb = step_lib.batch_to_device(batch, dev)
        loss, grads = step_lib._loss_and_grads(model, dict(model.named_parameters()), tb, key)
        masked = opt_lib.freeze_mask_grads(grads, model.trainable())
        refs[name] = {"loss": float(loss),
                      "grads": {k: g.float().cpu() for k, g in masked.items()}}
        del model, tb, grads, masked
        torch.cuda.empty_cache()

    def check(tag, ref, res):
        grads = res[0]["grads"]
        grad_rel = {k: float(np.linalg.norm(grads[k] - g.numpy()) / float(g.norm()))
                    for k, g in ref["grads"].items() if float(g.norm()) > 0}
        frozen_zero = all(not grads[k].any() for k, g in ref["grads"].items()
                          if float(g.norm()) == 0)
        loss_rel = max(abs(r["loss"] - ref["loss"]) / abs(ref["loss"]) for r in res)
        if loss_rel > TOL_LOSS_REL or not frozen_zero or max(grad_rel.values()) > TOL_GRAD_REL \
                or not all(r["frozen_unchanged"] for r in res):
            raise AssertionError(
                f"{tag} disagrees with the single-process step: loss rel {loss_rel} (tol "
                f"{TOL_LOSS_REL}), grads {grad_rel} (tol {TOL_GRAD_REL}), frozen grads zero "
                f"{frozen_zero}, frozen unchanged {[r['frozen_unchanged'] for r in res]}")
        return {"loss_rel_err": loss_rel, "grad_max_rel_err": max(grad_rel.values())}

    steps, launches, fit_out = {}, {}, None
    with tempfile.TemporaryDirectory() as fit_dir:
        for shape in GSPMD_MESHES:
            mname = "x".join(map(str, shape))
            families = FAM_TRAIN[(2, 2)] if shape == GSPMD_FAM_MESH else ()
            out = run_ranks(_gspmd_rank, int(np.prod(shape)),
                            (str(dev), shape, speech.to_json(),
                             {k: v.to_json() for k, v in fams.items()}, families,
                             fit_dir if shape == GSPMD_FIT_MESH else None),
                            timeout_s=GSPMD_TIMEOUT_S)
            hsharded = shape[1] > 1
            for name in ("speech", *families):
                res = [r["speech"] if name == "speech" else r["families"][name] for r in out]
                tag = f"{name} {mname}"
                got = check(tag, refs[name], res)
                for r in res:
                    c = r["launches"]
                    k12 = c["bilstm_tm_fwd"] + c["bilstm_tm_bwd"]
                    ok = (k12 == 0) if hsharded else (c["bilstm_tm_fwd"] > 0 and
                                                      c["bilstm_tm_bwd"] > 0)
                    if not (ok and c["ctc_fwd"] > 0 and c["ctc_bwd"] > 0 and
                            c["lstm_tm_fwd"] + c["lstm_tm_bwd"] == 0):
                        raise AssertionError(f"{tag}: a rank took the wrong kernels: {c}")
                launches[tag] = res[0]["launches"]
                steps[tag] = {**got, "launches_rank0": res[0]["launches"],
                              "all_reduces_per_step_rank0": res[0]["all_reduces"]}
                if name == "late_fusion":
                    steps[tag]["frozen_encoders_bit_unchanged"] = True
            if shape == GSPMD_FIT_MESH:
                fits = [r["fit"] for r in out]
                if len({f["digest"] for f in fits}) != 1 or fits[0]["epochs_run"] != 1:
                    raise AssertionError(f"the {mname} fit's ranks disagree")
                model = _family_model("speech", {"speech": speech}, dev)
                ckpt_lib.load_params(fit_dir, "speech", model, slot="best")
                corpus = _speech_corpus(speech, N_GSPMD_TRAIN + N_GSPMD_VAL, SEED + 70)
                best, emit = Decoder.for_model(model, "speech").decode_fn(
                    corpus[0][:GSPMD_B], None)
                want_best, want_emit = fits[0]["decode"]
                if _digest(model) != fits[0]["digest"] or not (
                        np.array_equal(best.cpu().numpy(), want_best)
                        and np.array_equal(emit.cpu().numpy(), want_emit)):
                    raise AssertionError(f"the {mname} fit's slot does not decode as rank 0's "
                                         f"in-memory parameters do")
                launches[f"fit {mname}"] = fits[0]["launches"]
                fit_out = {"history": fits[0]["history"], "ranks_agree": True,
                           "slot_decodes_bit_for_bit": True,
                           "launches_rank0": fits[0]["launches"]}
    phase("gspmd", pipeline="speech", B=GSPMD_B, T=speech.maxlen, H=speech.encoder.hidden,
          noise=speech.encoder.input_noise, dropout=list(speech.encoder.dropout),
          families_depth=GSPMD_FAM_DEPTH, families_B=GSPMD_FAM_B, backend="gloo",
          ranks_share_one_card=True, tol_loss_rel=TOL_LOSS_REL, tol_grad_rel=TOL_GRAD_REL,
          steps=steps, fit=fit_out)
    return launches


def _video_batch(cfg, B, seed):
    """A batch of B seeded videos as ``LazyVideoBatcher`` gives it: (B, T,
    D, D, 1) f32 pixels through ``(x - 128) / 255``, 1..N labels each."""
    rng = np.random.default_rng(seed)
    T, D = cfg.maxlen, cfg.cnn.img_dim
    x = rng.integers(0, 256, (B, T, D, D, 1), dtype=np.uint8).astype(np.float32)
    x -= 128.0
    x /= 255.0
    lab_len = rng.integers(1, cfg.max_label_len + 1, size=B).astype(np.int32)
    labels = np.full((B, cfg.max_label_len), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    return {"inputs": x, "labels": labels, "label_length": lab_len,
            "input_length": np.full((B,), T - cfg.ctc.trim_frames, np.int32)}


def _bench_line(argv, keys) -> dict:
    """``mgr_tpu_torch.bench.main(argv)`` in this process: its one JSON line,
    which must have the JAX bench's ``keys`` (no ``stale`` key) and
    positive numbers."""
    import io

    from mgr_tpu_torch import bench

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = bench.main(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench {argv}: rc {rc}, lines {lines}")
    return _checked_bench_line(json.loads(lines[0]), keys, argv)


def _checked_bench_line(line, keys, argv) -> dict:
    rates = [line["value"], line["spread"]["min"], line["spread"]["max"]]
    if "decode_spread" in line:
        rates += [line["decode_seqs_per_sec_per_chip"], line["decode_spread"]["min"],
                  line["decode_spread"]["max"]]
    if set(line) != keys or not all(np.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"bench {argv}: not the JAX bench's line: {line}")
    return line


def _bench_step_launches(name, dev) -> dict:
    """The kernels one bench train step and one bench decode step of
    ``name`` launch, at its bench defaults (the same seeded batch on the
    card, the same decode call)."""
    from mgr_tpu_torch import bench
    from mgr_tpu_torch.core import prng
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.ops import dispatch
    from mgr_tpu_torch.train import step as step_lib

    spec = bench.PIPELINES[name]
    cfg = get_preset(name).replace(batch_size=spec["batch"])
    model = build_model(cfg, device=dev)
    state = step_lib.create_train_state(model)
    train_step = step_lib.make_train_step(model)
    batch = bench._make_batch(cfg, spec["batch"], dev)
    call = bench._decode_call(cfg, model, spec["batch"], spec["threshold"], dev)
    dispatch.reset_launch_counts()
    _, m = train_step(state, batch, prng.root_key(0), 1.0)
    float(m["loss"])
    train = dispatch.launch_counts()
    dispatch.reset_launch_counts()
    best, _ = call()
    int(best[0, 0])
    decode = dispatch.launch_counts()
    del model, state, train_step, batch, call
    torch.cuda.empty_cache()
    return {"train_step": train, "decode_step": decode}


def bench_phase(dev) -> dict:
    """The port's bench (``mgr_tpu_torch/bench.py``) as users run it, at the
    JAX bench's defaults: every pipeline at full width, T=1900, its default
    batch (speech, skeletal and early fusion 128, late fusion 64, rgb 16),
    in this process, with its peak card memory; speech's ``--latency``
    (B=1); and ``python -m mgr_tpu_torch.cli.main bench`` (speech) in a
    subprocess. Every line has the JAX line's keys and positive rates.
    Each pipeline's bench run is counted (counts set to 0 before it, read
    after), and one train step's and one decode step's launches apart: K1-K4
    at least once a train step, K1 once a decode step, and the run's
    launches exactly the warm-up and timed calls' worth of them."""
    from mgr_tpu_torch import bench
    from mgr_tpu_torch.ops import dispatch

    calls_train = bench.WARMUP_STEPS + bench.REPEATS * bench.TIMED_STEPS
    calls_decode = 1 + bench.REPEATS * bench.TIMED_STEPS
    lines, launches = {}, {}
    for name in BENCH_PIPELINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        dispatch.reset_launch_counts()
        line = _bench_line(["--pipeline", name], BENCH_KEYS)
        run = dispatch.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if line["pipeline"] != name or line["batch"] != bench.PIPELINES[name]["batch"]:
            raise AssertionError(f"bench {name}: {line}")
        per = _bench_step_launches(name, dev)
        t, d = per["train_step"], per["decode_step"]
        if min(t[k] for k in KERNELS[:4]) < 1 or d["bilstm_tm_fwd"] < 1 or any(
                run[k] != calls_train * t[k] + calls_decode * d[k] for k in KERNELS):
            raise AssertionError(f"bench {name}: launches run {run}, a train step {t}, a "
                                 f"decode step {d}")
        print(json.dumps(line), flush=True)
        lines[name] = {"line": line, "peak_memory_gib": peak / 2**30}
        launches[name] = {**per, "run": run}
    dispatch.reset_launch_counts()
    latency = _bench_line(["--pipeline", "speech", "--latency"], LATENCY_KEYS)
    launches["speech latency"] = dispatch.launch_counts()
    if latency["batch"] != 1 or latency["spread"]["calls"] != bench.LATENCY_CALLS or \
            launches["speech latency"]["bilstm_tm_fwd"] < 1:
        raise AssertionError(f"bench --latency: {latency}, {launches['speech latency']}")
    print(json.dumps(latency), flush=True)
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "mgr_tpu_torch.cli.main", "bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=BENCH_CLI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the bench CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = proc.stdout.strip().splitlines()
    if len(out) != 1:
        raise AssertionError(f"the bench CLI printed {out}")
    cli = _checked_bench_line(json.loads(out[0]), BENCH_KEYS, ["bench"])
    print(json.dumps(cli), flush=True)
    phase("bench", lines=lines, latency=latency, cli=cli, launches=launches,
          calls_a_run={"train": calls_train, "decode": calls_decode})
    return launches


def dryrun_phase(dev) -> dict:
    """``mgr_tpu_torch.entry.dryrun_multichip`` on the card, at 8 ranks
    (phase 1 on 2x2x2: the GSPMD route's H-sharded recurrence, no K1/K2)
    and 2 (phase 1 on 1x2x1: each rank one direction, K5a/K5b), every rank
    time-sharing this card through gloo; each prints its ``ok`` line. Rank
    0's launches in each phase must be its route's kernels."""
    from mgr_tpu_torch.entry import dryrun_multichip

    runs, launches = {}, {}
    for n in DRYRUN_RANKS:
        torch.cuda.empty_cache()
        res = dryrun_multichip(n)
        c = res["launches"]
        k12, k14, k5 = KERNELS[:2], KERNELS[:4], KERNELS[4:6]
        gspmd = n % 8 == 0  # phase 1 on 2x2x2; else 1x2x1, direction-sharded
        expect = {  # phase: (kernels launched, kernels not launched)
            "1": (("ctc_fwd", "ctc_bwd") + (() if gspmd else k5), k12 + (k5 if gspmd else ())),
            "2": (k14, k5),
            "3": (k5 + ("ctc_fwd", "ctc_bwd"), k12),
            "4": (("bilstm_tm_fwd",), ("bilstm_tm_bwd", "ctc_fwd", "ctc_bwd") + k5),
            "5": (k14, k5),
        }
        wrong = {k: c[k] for k, (yes, no) in expect.items()
                 if not all(c[k][x] > 0 for x in yes) or any(c[k][x] for x in no)}
        if wrong:
            raise AssertionError(f"dryrun_multichip({n}): rank 0 took the wrong kernels in "
                                 f"phases {wrong}")
        runs[str(n)] = {"line": res["line"], "loss": res["loss"],
                        "split_leaves_checked": res["split_leaves_checked"],
                        **{k: res[k] for k in ("dp", "tp", "late_fusion", "decode_emitted")}}
        launches.update({f"{n} ranks phase {k}": v for k, v in c.items()})
    phase("dryrun", backend="gloo", ranks_share_one_card=True, runs=runs, launches_rank0=launches)
    return launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    kind = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    measured = {"bilstm_tm_fwd": k1_phase(dev), "bilstm_tm_bwd": k2_phase(dev),
                "ctc_fwd": k3_phase(dev), "ctc_bwd": k4_phase(dev), **k5_phase(dev),
                **k6_phase(dev)}
    batch_major = bm_path_phase(dev)
    serving = slice_phase(dev)
    training = train_phase(dev)
    fit_path = fit_path_phase(dev)
    synthetic = synthetic_phase(dev)
    examples = examples_phase(dev)
    fusion_shapes = fusion_kernels_phase(dev)
    fusion = fusion_phase(dev)
    rgb_shapes = rgb_kernels_phase(dev)
    rgb = rgb_phase(dev)
    prepare = prepare_phase(dev)
    mesh = mesh_phase(dev)
    families = mesh_families_phase(dev)
    gspmd = gspmd_phase(dev)
    benched = bench_phase(dev)
    dryrun = dryrun_phase(dev)
    from mgr_tpu_torch.ops import dispatch

    replaces = {"bilstm_tm_fwd": 775, "bilstm_tm_bwd": 856, "ctc_fwd": 410, "ctc_bwd": 491,
                "lstm_tm_fwd": 1086, "lstm_tm_bwd": 1151, "lstm_scan_fwd": 67,
                "lstm_scan_bwd": 164}
    # The kernel table (PERF.md section 6), one entry a kernel: its times
    # and its errors against its plain version from the kernel phases (K5
    # also at the family meshes' shapes, K1-K4 also at the fusion and rgb
    # shapes), each with its bound from benchmark/roofline.py; and the
    # launches each full-width path made:
    # K1-K4 from the training path (the one-process main path), with the
    # serving path's counts of K1 and K3, the fusion path's (both families'
    # fit, decode and evaluate), the rgb path's (fit, decode, evaluate,
    # infer) and the prepare path's (the prepared speech corpus trained and
    # decoded); K5a/K5b from rank 0 of the 2x2 mesh's train and eval step
    # (the mesh path); K6a/K6b from the batch-major layer path; K1-K4 also
    # from the fit path's main path (train speech through the CLI on the
    # device-resident corpus, then decode of a msgpack workdir), from the
    # synthetic path (the learning run's fit, decode and evaluate, then
    # train and decode speech through the CLI on the synthetic corpus) and
    # from each learning driver of the examples path; every kernel also
    # from rank 0 of each path of the mesh_families phase (each family's
    # mesh train and eval step, each mesh decode, the curriculum on 2x1)
    # and of the gspmd phase (speech's mesh step on each mesh, each
    # family's on 1x4, the fit over 1x2x2); from each pipeline's bench run
    # (and one bench train step and one decode step of it), speech's
    # latency run; and from rank 0 of each phase of the dryrun at 8 and 2
    # ranks.
    paths = {"lstm_tm": mesh, "lstm_scan": batch_major}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"mgr_tpu_torch/csrc/{dispatch.SOURCES[name]}.cu",
         "replaces": f"mgr_tpu/ops/pallas_kernels.py:{replaces[name]}",
         "launches": paths.get(name.rsplit("_", 1)[0], training)[name],
         **({"launches_serving": serving[name]} if name in serving else {}),
         **({"launches_fusion": fusion[name], "at_fusion_shape": fusion_shapes[name]}
            if name in fusion_shapes else {}),
         **({"launches_rgb": rgb[name], "at_rgb_shape": rgb_shapes[name]}
            if name in rgb_shapes else {}),
         **({"launches_prepare": prepare[name], "launches_fit_path": fit_path[name],
             "launches_synthetic": synthetic[name],
             "launches_examples": {path: c[name] for path, c in examples.items()}}
            if name in KERNELS[:4] else {}),
         "launches_mesh_families": {path: c[name] for path, c in families.items()},
         "launches_gspmd": {path: c[name] for path, c in gspmd.items()},
         "launches_bench": {path: {k: c[k][name] for k in c} if "train_step" in c else c[name]
                            for path, c in benched.items()},
         "launches_dryrun": {path: c[name] for path, c in dryrun.items()},
         **measured[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
