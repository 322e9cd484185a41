"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version at the speech shapes, then
serves the speech BLSTM+CTC pipeline end to end through the kernels.

    python3 chip_smoke.py [--profile]

Phases, one line each: device, build, K1 (BiLSTM recurrence) against
its plain version, K3 (CTC forward) against its plain version, the
serving slice (decode -> MLF -> evaluate -> eval loss -> B=1 infer),
with ``--profile`` a per-layer breakdown of a decode step at B=1, 32
and 128, a JSON line of the kernels, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed phase
raises, so the exit code is not 0 and the last line is never printed.
There is no CPU fallback: without a CUDA device the script fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

# The port must need neither JAX nor the JAX package: make any import of
# them fail loudly.
sys.modules["jax"] = None
sys.modules["mgr_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
B_K1, T_K1, H_K1 = 128, 1900, 500          # speech encoder shapes
B_K3, T_K3, K_K3, N_K3 = 128, 1898, 44, 150  # speech CTC shapes (T - trim)
TOL_K1_H = 3e-2        # max |h| diff: bf16 h stream, f32 sums in another order
TOL_K3_REL = 1e-4      # |loss| diff relative to max(1, |loss|): f32 lse chain
TOL_LOGITS = 3e-2      # slice logits, kernel path vs plain path (bf16 model)
TOL_LOSS_REL = 1e-3    # slice mean eval loss, kernel path vs plain path
N_FILES, B_SLICE = 128, 32  # 4 batches at the preset's batch size


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU fallback here")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    phase("device", kind=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    return name


def build_phase() -> None:
    from mgr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    for name in ("bilstm_tm_fwd", "ctc_fwd"):
        build.load(name)
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in build.build_log(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in ("bilstm_tm_fwd", "ctc_fwd")
    }
    phase("build", seconds=secs, ptxas=ptxas)


def k1_phase(dev) -> dict:
    from mgr_tpu_torch.kernels.bilstm_tm import bilstm_tm
    from mgr_tpu_torch.ops.lstm import bilstm_scan_tm_plain, init_bilstm_params

    rng = np.random.default_rng(SEED)
    xps = []
    for _ in range(2):
        xp = 0.5 * rng.standard_normal((T_K1, B_K1, 4, H_K1), dtype=np.float32)
        xp[:, :, 1, :] += 1.0  # unit forget bias, as after the projection
        xps.append(torch.from_numpy(xp).to(dev, torch.bfloat16))
    gen = torch.Generator().manual_seed(SEED)
    U = init_bilstm_params(gen, 8, H_K1)["U"].to(dev, torch.bfloat16)

    got = bilstm_tm(xps[0], xps[1], U)
    want = bilstm_scan_tm_plain(xps[0], xps[1], U)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # Edge shapes of the same kernel: B=1 (infer), a partial second batch
    # tile (B=130), three launches of at most 256 rows (B=520), an odd H
    # (padded by the wrapper); c streams stored.
    for T, B, H in ((64, 1, 500), (64, 130, 300), (32, 520, 64), (64, 3, 7)):
        xe = torch.from_numpy(
            0.5 * rng.standard_normal((2, T, B, 4, H), dtype=np.float32)
        ).to(dev, torch.bfloat16)
        Ue = init_bilstm_params(gen, 8, H)["U"].to(dev, torch.bfloat16)
        ge = bilstm_tm(xe[0], xe[1], Ue, store_c=True)
        we = bilstm_scan_tm_plain(xe[0], xe[1], Ue, store_c=True)
        torch.cuda.synchronize()
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(ge, we)])
    if not all(torch.isfinite(g).all() for g in got) or err > TOL_K1_H:
        raise AssertionError(f"K1 disagrees with its plain version: max |dh| {err} > {TOL_K1_H}")
    ms = cuda_time_ms(lambda: bilstm_tm(xps[0], xps[1], U), reps=5)
    plain_ms = cuda_time_ms(lambda: bilstm_scan_tm_plain(xps[0], xps[1], U), reps=1)
    phase("k1_bilstm_tm_fwd", B=B_K1, T=T_K1, H=H_K1, max_abs_err_h=err,
          tol=TOL_K1_H, ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def k3_phase(dev) -> dict:
    from mgr_tpu_torch.kernels.ctc import ctc_alpha_loss
    from mgr_tpu_torch.ops.ctc import ctc_alpha_loss_plain

    rng = np.random.default_rng(SEED + 1)
    logits = rng.standard_normal((T_K3, B_K3, K_K3), dtype=np.float32)
    lp = torch.log_softmax(torch.from_numpy(logits).to(dev), dim=-1)
    blank = K_K3 - 1
    lab_len = rng.integers(1, N_K3 + 1, size=B_K3)
    lab_len[0], lab_len[1], lab_len[2] = 0, N_K3, 1  # all-blank, full, single
    in_len = rng.integers(2 * N_K3 + 2, T_K3 + 1, size=B_K3)
    in_len[1] = T_K3
    labels = np.full((B_K3, N_K3), -1, np.int32)
    for b in range(B_K3):
        seq = rng.integers(0, blank, size=lab_len[b])
        if b % 3 == 0 and lab_len[b] > 1:  # runs of repeated labels
            seq[1::2] = seq[0::2][: len(seq[1::2])]
        labels[b, : lab_len[b]] = seq
    args = [torch.from_numpy(a).to(dev) for a in
            (labels, in_len.astype(np.int32), lab_len.astype(np.int32))]

    got = ctc_alpha_loss(lp, *args, blank)
    want = ctc_alpha_loss_plain(lp, *args, blank)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    rel = float((diff / want.abs().clamp_min(1.0)).max())
    if not torch.isfinite(got).all() or rel > TOL_K3_REL:
        raise AssertionError(f"K3 disagrees with its plain version: rel {rel} > {TOL_K3_REL}")
    ms = cuda_time_ms(lambda: ctc_alpha_loss(lp, *args, blank), reps=20)
    plain_ms = cuda_time_ms(lambda: ctc_alpha_loss_plain(lp, *args, blank), reps=1)
    phase("k3_ctc_fwd", B=B_K3, T=T_K3, K=K_K3, N=N_K3,
          max_abs_err_loss=float(diff.max()), max_rel_err_loss=rel, tol_rel=TOL_K3_REL,
          ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": float(diff.max()), "ms": ms, "plain_ms": plain_ms}


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls to the plain versions, for the
    comparison only (the package itself has no such switch)."""
    from mgr_tpu_torch.kernels import bilstm_tm as k1, ctc as k3
    from mgr_tpu_torch.ops.ctc import ctc_alpha_loss_plain
    from mgr_tpu_torch.ops.lstm import bilstm_scan_tm_plain

    saved = k1.bilstm_tm, k3.ctc_alpha_loss
    k1.bilstm_tm = lambda xp0, xp1, U, store_c=False: bilstm_scan_tm_plain(
        xp0, xp1, U, store_c=store_c)
    k3.ctc_alpha_loss = ctc_alpha_loss_plain
    try:
        yield
    finally:
        k1.bilstm_tm, k3.ctc_alpha_loss = saved


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
    dec.decode_batches(batches[:1])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    results = dec.decode_batches(batches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        mlf_path = os.path.join(tmp, MLF_FILENAMES["speech"])
        dec.write_mlf(mlf_path, results)
        n_mlf = len(read_mlf(mlf_path))
    metrics = evaluate_accuracy(model, data)
    losses = [float(eval_step(b)) for _, b in batches]
    x1, true_len = pad_or_truncate(feats[0][: T - 300], T)
    one = {"inputs": x1[None], "input_length": np.asarray([true_len - trim], np.int32)}
    infer_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        tokens = dec.decode_batches([((ids[0],), one)])
        infer_ms.append(1e3 * (time.perf_counter() - t1))
    launches = dispatch.launch_counts()

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

    # Decode throughput at B=128 (one batch of the same files).
    big = {"inputs": feats[:128], "input_length": in_len[:128]}
    dec.decode_batches([(ids[:128], big)])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dec.decode_batches([(ids[:128], big)])
    torch.cuda.synchronize()
    seqs_s_128 = len(big["inputs"]) / (time.perf_counter() - t2)

    phase("slice", pipeline="speech", B=B_SLICE, T=T, files=N_FILES,
          launches=launches, decode_seq_per_s_b32=N_FILES / decode_s,
          decode_seq_per_s_b128=seqs_s_128,
          infer_b1_ms_median=float(np.median(infer_ms)), mlf_entries=n_mlf,
          accuracy=metrics["accuracy"], eval_loss_mean=float(np.mean(losses)),
          logits_max_abs_err=d_logits, tol_logits=TOL_LOGITS,
          loss_rel_err=d_loss, tol_loss_rel=TOL_LOSS_REL)
    return launches


def _device_us(prof) -> float:
    """Device time of the kernels and copies a torch.profiler run traced.
    Only the device's own rows count: a host op's row also carries the
    device time of the kernels it launched, which would count them twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def profile_phase(dev) -> None:
    """Where a decode step's time goes, at B=1, 32 and 128: CUDA-event
    times of each layer of one step (the model's own functions, called in
    its order), the host-clock wall of the real decode step, and the
    device's idle share of a profiled step."""
    from mgr_tpu_torch.core.config import get_preset
    from mgr_tpu_torch.kernels.bilstm_tm import bilstm_tm
    from mgr_tpu_torch.ops.ctc import ctc_loss_from_logits
    from mgr_tpu_torch.ops.decoding import best_path_decode
    from mgr_tpu_torch.ops.lstm import input_projection
    from mgr_tpu_torch.decode.decoder import DECODE_SPECS
    from mgr_tpu_torch.models.zoo import build_model
    from mgr_tpu_torch.train.step import make_decode_step

    cfg = get_preset("speech")
    spec = DECODE_SPECS["speech"]
    T, trim, cd = cfg.maxlen, cfg.ctc.trim_frames, torch.bfloat16
    model = build_model(cfg, seed=SEED, device=dev)
    step = make_decode_step(model, threshold=spec.threshold, trim_frames=spec.trim_frames)
    rng = np.random.default_rng(SEED + 3)
    feats = rng.standard_normal((128, T, cfg.num_feats), dtype=np.float32)
    labels = torch.from_numpy(rng.integers(0, cfg.nb_classes - 1, (128, cfg.max_label_len),
                                           dtype=np.int32)).to(dev)
    lab_len = torch.full((128,), cfg.max_label_len, dtype=torch.int32, device=dev)
    in_len = torch.full((128,), T - trim, dtype=torch.int32, device=dev)

    def timed_step(x_np, B):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        with torch.inference_mode():
            mark("start")
            x = torch.from_numpy(x_np).to(dev)
            mark("input copy to the card")
            h, outs = x.transpose(0, 1), []
            for i in range(cfg.encoder.depth):
                layer = getattr(model.encoder, f"blstm_{i}")
                xp0 = input_projection(h, layer.W[0], layer.b[0], cd)
                xp1 = input_projection(h, layer.W[1], layer.b[1], cd)
                mark(f"projection, layer {i} (2 dirs)")
                hs0, hs1 = bilstm_tm(xp0, xp1, layer.U)
                mark(f"K1, layer {i}")
                h = torch.cat([hs0, hs1], dim=-1).to(cd)
                mark(f"concat + cast, layer {i}")
                outs.append(h)
            logits_tm = model.head(outs[-2] + outs[-1], cd)
            best, emit = best_path_decode(
                torch.softmax(logits_tm.transpose(0, 1), dim=-1), None,
                threshold=spec.threshold, trim_frames=spec.trim_frames)
            mark("residual + head + softmax + best-path")
            best.cpu(), emit.cpu()
            mark("copy of (best, emit) to the host")
            ctc_loss_from_logits(logits_tm, labels[:B], in_len[:B], lab_len[:B],
                                 trim_frames=trim, time_major=True)
            mark("eval only: log-softmax + K3")
            torch.cuda.synchronize()
            if not torch.equal(logits_tm, model.apply_tm(x)):
                raise AssertionError("the profiled layers are not the model's forward")
        return {name: marks[k - 1][1].elapsed_time(e)
                for k, (name, e) in enumerate(marks) if k > 0}

    def real_step(x_np):
        best, emit = step(x_np)
        best.cpu(), emit.cpu()

    for B, n in ((1, 21), (32, 7), (128, 7)):
        x_np = feats[:B]
        for _ in range(2):
            real_step(x_np)  # warm-up
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            real_step(x_np)
            walls.append(1e3 * (time.perf_counter() - t0))
        layers = [timed_step(x_np, B) for _ in range(3)]
        layers_ms = {k: float(np.median([lay[k] for lay in layers])) for k in layers[0]}
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            real_step(x_np)
            torch.cuda.synchronize()
            prof_wall_us = 1e6 * (time.perf_counter() - t0)
        dev_us = _device_us(prof)
        phase("profile", pipeline="speech", B=B, T=T, step_wall_ms_median=float(np.median(walls)),
              n=n, layers_ms=layers_ms, profiled_wall_ms=prof_wall_us / 1e3,
              device_ms=dev_us / 1e3,
              idle_share=(1.0 - dev_us / prof_wall_us) if dev_us > 0 else None)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print where a decode step's time goes (B=1, 32, 128)")
    args = parser.parse_args()
    kind = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    k1 = k1_phase(dev)
    k3 = k3_phase(dev)
    launches = slice_phase(dev)
    if args.profile:
        profile_phase(dev)
    kernels = [
        {"name": "bilstm_tm_fwd", "route": "cuda",
         "source": "mgr_tpu_torch/csrc/bilstm_tm_fwd.cu",
         "replaces": "mgr_tpu/ops/pallas_kernels.py:775",
         "launches": launches["bilstm_tm_fwd"], **k1},
        {"name": "ctc_fwd", "route": "cuda",
         "source": "mgr_tpu_torch/csrc/ctc_fwd.cu",
         "replaces": "mgr_tpu/ops/pallas_kernels.py:410",
         "launches": launches["ctc_fwd"], **k3},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
