"""The port's mesh path (mgr_tpu_torch.parallel, the mesh train and eval
steps, fit over a mesh, ``train --mesh``) and the plain versions of K5a/K5b
held against the JAX package.

The mesh tests run gloo process groups of spawned CPU ranks
(``parallel.spawn.run_ranks``; rank bodies in ``torch_parallel_ranks.py``,
which imports no JAX), each with a time limit, against the JAX package's
shard_map steps on the virtual CPU devices of ``tests/conftest.py``.

Tolerances, each with its reason:
  * plain K5a/K5b (bf16) vs ``pallas_lstm_tm(interpret=True)``: h 3e-2
    absolute (bf16 h stream, one ulp ~4e-3, as K1's tests); dxp within
    1e-2 of the largest |dxp| and dU 1e-3 relative Frobenius (the same
    values rounded at the same places, f32 sums in another order; as
    K2's tests).
  * the single-direction pair vs the two-direction plain version: equal
    (the same arithmetic).
  * a direction-sharded layer in f32 vs ``bilstm_layer_tm`` (XLA path):
    values 1e-5 absolute, gradients 1e-4 of the largest |gradient| (f32
    sums in another order; the exchange itself is exact).
  * the 2x2 mesh train step vs JAX's mesh step (f32, noise and dropout
    off): loss rtol 1e-5, parameters rtol 2e-4 / atol 2e-6, as
    tests/test_tp_dirsharded.py:174-186; raw gradients vs JAX's
    single-device ``_loss_and_grads`` rtol 1e-4 / atol 1e-6 (:211-218);
    eval loss rtol 1e-5.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgr_tpu.ops.pallas_kernels as pk
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng as jprng
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.ops import lstm as jlstm
from mgr_tpu.parallel import make_mesh as jmake_mesh
from mgr_tpu.parallel import shard_batch as jshard_batch
from mgr_tpu.parallel import shard_params as jshard_params
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.kernels import bilstm_tm as k1
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.ops import lstm as tlstm
from mgr_tpu_torch.parallel import multihost, sharding
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import loop as tloop
from mgr_tpu_torch.train import step as tstep

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
TOL_BF16 = 3e-2
TOL_DXP_REL = 1e-2
TOL_DU_REL = 1e-3


# ------------------------------------------------------- K5a/K5b plain versions


def _k5_case(seed, T, B=4, H=8):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((T, B, 4, H))).astype(np.float32)
    U = (0.3 * rng.standard_normal((H, 4, H))).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    return xp, U, g


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [8, 13])  # 13: no multiple of the TPU chunk
def test_k5_plain_matches_pallas_lstm_tm(reverse, T):
    """Values and (dxp, dU) of the plain K5a/K5b, through LSTMTm on the CPU,
    against jax.vjp of pallas_lstm_tm in interpret mode. T = 13 pins the
    padding: JAX pads T at the end and a reverse scan walks the padding
    first; the plain version does not pad."""
    xp, U, g = _k5_case(T + int(reverse), T)
    bf = torch.bfloat16
    jx = jnp.asarray(xp, jnp.bfloat16)
    jh, vjp = jax.vjp(lambda a, u: pk.pallas_lstm_tm(a, u, reverse=reverse, interpret=True),
                      jx, jnp.asarray(U))
    jdx, jdU = (np.asarray(v.astype(jnp.float32)) for v in vjp(jnp.asarray(g)))

    (hs,) = tlstm.lstm_scan_tm_plain(torch.from_numpy(xp).to(bf), torch.from_numpy(U).to(bf),
                                     reverse=reverse)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jh), atol=TOL_BF16, rtol=0)

    xt = torch.from_numpy(xp).to(bf).requires_grad_()
    Ut = torch.from_numpy(U).requires_grad_()
    h = k1.LSTMTm.apply(xt, Ut, reverse)
    assert h.dtype == torch.float32 and h.shape == (T, 4, 8)
    (h * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == bf and Ut.grad.dtype == torch.float32
    dx = xt.grad.float().numpy()
    assert np.abs(dx - jdx).max() <= TOL_DXP_REL * np.abs(jdx).max()
    dU = Ut.grad.numpy()
    assert np.linalg.norm(dU - jdU) <= TOL_DU_REL * np.linalg.norm(jdU)
    # dU is rounded through bf16, as JAX rounds it to the kernel's bf16 U1.
    assert np.array_equal(dU, Ut.grad.to(bf).float().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_pair_equals_two_direction_plain(dtype):
    """The forward scan of direction 0 and the reverse scan of direction 1
    give the two-direction plain version's streams and adjoints exactly."""
    T, B, H = 13, 3, 8
    rng = np.random.default_rng(3)
    xp0, xp1 = (torch.from_numpy(rng.standard_normal((T, B, 4, H)).astype(np.float32)).to(dtype)
                for _ in range(2))
    U = torch.from_numpy((0.3 * rng.standard_normal((2, H, 4, H))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, T, B, H)).astype(np.float32)).to(dtype)
    two = tlstm.bilstm_scan_tm_plain(xp0, xp1, U, store_c=True, out_dtype=dtype)
    one0 = tlstm.lstm_scan_tm_plain(xp0, U[0], reverse=False, store_c=True, out_dtype=dtype)
    one1 = tlstm.lstm_scan_tm_plain(xp1, U[1], reverse=True, store_c=True, out_dtype=dtype)
    for a, b in zip(two, (one0[0], one1[0], one0[1], one1[1])):
        assert torch.equal(a, b)
    dz0, dz1, dU = tlstm.bilstm_scan_tm_bwd_plain(xp0, xp1, U, *two, g[0], g[1])
    d0, u0 = tlstm.lstm_scan_tm_bwd_plain(xp0, U[0], one0[0], one0[1], g[0], reverse=False)
    d1, u1 = tlstm.lstm_scan_tm_bwd_plain(xp1, U[1], one1[0], one1[1], g[1], reverse=True)
    assert torch.equal(dz0, d0) and torch.equal(dz1, d1)
    assert torch.equal(dU, torch.stack([u0, u1]))
    # The wrappers route a CPU tensor to the same plain versions.
    assert torch.equal(k1.lstm_tm_streams(xp1, U[1], reverse=True)[0], one1[0])
    assert torch.equal(k1.lstm_tm_bwd(xp1, U[1], one1[0], one1[1], g[1], reverse=True), d1)


def test_k5_wrappers_check_shapes():
    xp = torch.zeros((5, 2, 4, 8))
    with pytest.raises(ValueError, match="U1"):
        k1.lstm_tm_streams(xp, torch.zeros((2, 8, 4, 8)), reverse=False)
    with pytest.raises(ValueError, match="streams"):
        k1.lstm_tm_bwd(xp, torch.zeros((8, 4, 8)), torch.zeros((5, 2, 8)),
                       torch.zeros((5, 2, 8)), torch.zeros((4, 2, 8)), reverse=True)


# ------------------------------------------------------------- collectives


def test_gather_directions_forward_is_exact_and_backward_sums():
    """Forward: both ranks get both streams, bit for bit. Backward: the
    cotangent summed over the two ranks, this rank's slot (psum_scatter)."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    g = rng.standard_normal((2, 2, 5, 3, 4)).astype(np.float32)
    out = run_ranks(ranks.gather_rank, 2, (h, g), timeout_s=TIMEOUT_S)
    for r, (both, dh) in enumerate(out):
        np.testing.assert_array_equal(both, h)
        np.testing.assert_array_equal(dh, g[0][r] + g[1][r])


def test_a_failing_rank_fails_the_run_without_hanging():
    with pytest.raises(RuntimeError, match="rank failed on purpose"):
        run_ranks(ranks.barrier_rank, 2, (1,), timeout_s=TIMEOUT_S)


def test_a_hung_rank_is_killed_at_the_time_limit():
    with pytest.raises(TimeoutError):
        run_ranks(ranks.sleep_rank, 2, (600,), timeout_s=20)


# ------------------------------------------------ the direction-sharded layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dirsharded_layer_matches_jax_layer(dtype):
    """A 2-rank gloo bilstm_layer_tm under the direction-shard context
    against JAX's bilstm_layer_tm on one device: values and gradients (the
    two ranks' gradients combined as the mesh step combines them). Each
    rank runs only the single-direction wrappers."""
    T, B, F, H = 13, 3, 5, 8
    p = {k: np.array(v) for k, v in jlstm.init_bilstm_params(jax.random.key(2), F, H).items()}
    x = np.random.default_rng(5).standard_normal((T, B, F)).astype(np.float32)
    g = np.random.default_rng(6).standard_normal((T, B, 2 * H)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]

    def f(q):
        out = jlstm.bilstm_layer_tm(q, jnp.asarray(x), compute_dtype=jd)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, want), jgrad = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    want = np.asarray(want.astype(jnp.float32))
    out = run_ranks(ranks.layer_rank, 2, (p, x, g, dtype), timeout_s=TIMEOUT_S)
    for got, grads, calls in out:
        assert calls["lstm_tm_streams"] == 1 and calls["lstm_tm_bwd"] == 1
        assert calls["bilstm_tm_streams"] == calls["bilstm_tm_bwd"] == 0
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            for k in ("W", "U", "b"):
                w = np.asarray(jgrad[k])
                assert np.abs(grads[k] - w).max() <= 1e-4 * np.abs(w).max(), k
        else:  # the XLA bf16 path carries h in f32 where the kernels store bf16
            np.testing.assert_allclose(got, want, atol=TOL_BF16, rtol=0)
    np.testing.assert_array_equal(out[0][0], out[1][0])


# ------------------------------------------------------ the mesh train step


def _cfg(batch):
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
                               output_dropout=0.0)
    return cfglib.get_preset("speech").replace(
        maxlen=24, num_feats=5, nb_classes=6, max_label_len=4,
        batch_size=batch, encoder=enc, compute_dtype="float32")


def _batch(cfg):
    B = cfg.batch_size
    rng = np.random.default_rng(0)
    return {
        "inputs": rng.standard_normal((B, cfg.maxlen, cfg.num_feats)).astype(np.float32),
        "labels": np.pad(rng.integers(0, cfg.nb_classes - 1, size=(B, 2)),
                         ((0, 0), (0, cfg.max_label_len - 2)),
                         constant_values=-1).astype(np.int32),
        "input_length": np.full((B,), cfg.maxlen - 2, np.int32),
        "label_length": np.full((B,), 2, np.int32),
    }


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(tree).items()}


@pytest.fixture(scope="module")
def mesh22():
    """One 2x2 gloo mesh run (raw grads, eval, a train step) and JAX's 2x2
    shard_map steps and single-device grads on the same weights and batch."""
    cfg = _cfg(batch=8)
    jmodel = jbuild(cfg)
    state = jstep.create_train_state(jmodel, jprng.root_key(0))
    params = jax.tree.map(np.array, state.params)
    batch = _batch(cfg)
    mesh = jmake_mesh(cfglib.MeshConfig(data=2, model=2))
    jb = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    jloss1, jgrads1 = jax.jit(lambda p, b: jstep._loss_and_grads(jmodel, p, b, rng=None))(
        state.params, batch)
    jgrads1 = jax.tree.map(np.asarray, jgrads1)
    jeval = float(jstep.make_eval_step(jmodel, mesh=mesh)(
        jshard_params(state.params, mesh), jb))
    # The JAX step donates its state: it runs last.
    jnew, jm = jstep.make_train_step(jmodel, mesh=mesh)(
        state._replace(params=jshard_params(state.params, mesh)), jb, jax.random.key(7), 1.0)
    out = run_ranks(ranks.mesh_rank, 4, (cfg.to_json(), params, batch, (2, 2)),
                    timeout_s=TIMEOUT_S)
    return {"jax_loss": float(jm["loss"]), "jax_params": _flat(jax.tree.map(np.asarray,
                                                                             jnew.params)),
            "jax_eval": jeval, "jax_loss1": float(jloss1),
            "jax_grads1": _flat(jgrads1), "ranks": out}


def test_mesh22_train_step_matches_jax_mesh_step(mesh22):
    for r in mesh22["ranks"]:
        np.testing.assert_allclose(r["step_loss"], mesh22["jax_loss"], rtol=1e-5)
        assert r["params"].keys() == mesh22["jax_params"].keys()
        for k, want in mesh22["jax_params"].items():
            np.testing.assert_allclose(r["params"][k], want, rtol=2e-4, atol=2e-6, err_msg=k)
    # Every rank ends on the same replica.
    for r in mesh22["ranks"][1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, mesh22["ranks"][0]["params"][k])


def test_mesh22_raw_grads_match_jax_single_device(mesh22):
    """Raw gradients, not parameters after Adam: its first update is
    -lr * sign(g), which would hide a constant factor such as the 2 of the
    direction exchange's backward."""
    for r in mesh22["ranks"]:
        np.testing.assert_allclose(r["loss"], mesh22["jax_loss1"], rtol=1e-5)
        for k, want in mesh22["jax_grads1"].items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_mesh22_eval_step_matches_jax_mesh_eval(mesh22):
    for r in mesh22["ranks"]:
        np.testing.assert_allclose(r["eval"], mesh22["jax_eval"], rtol=1e-5)


def test_mesh22_routes_through_the_single_direction_kernels(mesh22):
    """Under model=2 every recurrence goes through the single-direction
    wrappers (K5a/K5b on the card), never the two-direction ones."""
    for r in mesh22["ranks"]:
        c = r["calls"]
        assert c["lstm_tm_streams"] > 0 and c["lstm_tm_bwd"] > 0, c
        assert c["bilstm_tm_streams"] == 0 and c["bilstm_tm_bwd"] == 0, c


def test_pure_dp_mesh_matches_single_process_step():
    """2x1 (pure DP): the mean of the two ranks' halves is the single
    process's step on the whole batch, through the two-direction path."""
    cfg = _cfg(batch=4)
    params = jax.tree.map(np.array, jbuild(cfg).init(jprng.root_key(1)))
    batch = _batch(cfg)
    model = bridge.load_params(tbuild(tconfig.PipelineConfig.from_json(cfg.to_json()), device="cpu"), params)
    loss, grads = tstep._loss_and_grads(
        model, dict(model.named_parameters()),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    grads = {k: g.numpy().copy() for k, g in grads.items()}
    state = tstep.create_train_state(model)
    state, m = tstep.make_train_step(model)(state, batch, None, 1.0)
    out = run_ranks(ranks.mesh_rank, 2, (cfg.to_json(), params, batch, (2, 1)),
                    timeout_s=TIMEOUT_S)
    for r in out:
        assert r["calls"]["bilstm_tm_streams"] > 0 and r["calls"]["lstm_tm_streams"] == 0
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        for k, want in grads.items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["step_loss"], float(m["loss"]), rtol=1e-5)
        for k, p in state.params.items():
            np.testing.assert_allclose(r["params"][k], p.detach().numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=k)


# ------------------------------------------------------- mesh layout helpers


@pytest.mark.parametrize("shape,axes", [((2, 2, 1), ("data", "model")),
                                        ((4, 1, 1), ("data", None)),
                                        ((2, 4, 1), None), ((2, 2, 2), None)])
def test_shardmap_axes(shape, axes):
    """None for a mesh of the GSPMD route, as JAX's ``shardmap_axes``."""
    assert sharding.shardmap_axes(tconfig.MeshConfig(*shape)) == axes


def test_shard_batch_takes_contiguous_rows_by_data_index():
    class M:
        data = 2
        data_index = 1
        time = 1

    batch = {"inputs": np.arange(12).reshape(6, 2), "labels": torch.arange(6)}
    got = sharding.shard_batch(batch, M())
    np.testing.assert_array_equal(got["inputs"], np.arange(6, 12).reshape(3, 2))
    assert torch.equal(got["labels"], torch.arange(3, 6))
    with pytest.raises(ValueError, match="split"):
        sharding.shard_batch({"x": np.zeros(5)}, M())


def test_initialize_is_a_noop_without_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("gloo") is False
    assert multihost.is_primary()
    assert multihost.process_info()["process_count"] == 1


# ------------------------------------------------------------ fit and CLI


def test_fit_over_a_dp_mesh_writes_on_rank_0_and_ranks_agree(tmp_path):
    """fit over a 2x1 mesh: rank 0 alone writes, both ranks end on the same
    parameters, and the losses are the single-process fit's."""
    cfg = _cfg(batch=2).replace(patience=50)
    params = jax.tree.map(np.array, jbuild(cfg).init(jprng.root_key(2)))
    b = _batch(cfg.replace(batch_size=8))
    ids = list(range(8))
    corpus = (b["inputs"], b["labels"], b["label_length"], b["input_length"], ids,
              ids[:6], ids[6:])
    out = run_ranks(ranks.fit_rank, 2, (cfg.to_json(), params, corpus,
                                        str(tmp_path / "mesh"), 2), timeout_s=TIMEOUT_S)
    assert out[0]["writes"] and not out[1]["writes"]
    assert out[0]["step"] == out[1]["step"] == 6
    for k, v in out[0]["params"].items():
        np.testing.assert_array_equal(v, out[1]["params"][k])
    assert sorted(os.listdir(tmp_path / "mesh")) == [
        "speech_best.params.pt", "speech_best.state.pt", "speech_config.json",
        "speech_fitmeta.json", "speech_latest.params.pt", "speech_latest.state.pt",
        "speech_metrics.jsonl"]
    from mgr_tpu_torch.data.batcher import Batcher

    model = bridge.load_params(tbuild(tconfig.PipelineConfig.from_json(cfg.to_json()), device="cpu"), params)
    single = tloop.fit(model, Batcher(*corpus[:5], train_ids=corpus[5], val_ids=corpus[6]),
                       epochs=2)
    for got, want in zip(out[0]["history"], single.history):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def skeletal_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh_cli"))
    sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
        root, n_files=10, frames_per_label=6, seed=3)
    return ["--skeletal-csv", sk_csv, "--labels", sk_labels]


def test_train_cli_mesh_under_torchrun(skeletal_corpus, tmp_path):
    """`train --mesh 2x1 --device cpu` through torch.distributed.run with 2
    processes (the CLI with the skeletal preset at test size): one result
    line (rank 0's), the slots in the workdir."""
    wd = str(tmp_path / "wd")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--nnodes", "1", "--master-addr", "localhost", "--master-port", str(_free_port()),
           os.path.join(ROOT, "tests", "torch_parallel_ranks.py"), "train", "skeletal",
           "--mesh", "2x1",
           "--device", "cpu", "--workdir", wd, "--epochs", "2", "--batch-size", "2",
           "--compute-dtype", "float32", *skeletal_corpus]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    assert '"epochs_run": 2' in lines[0]
    assert {"skeletal_best.params.pt", "skeletal_latest.state.pt",
            "skeletal_config.json"} <= set(os.listdir(wd))
    assert '"data": 2' in open(os.path.join(wd, "skeletal_config.json")).read()


def test_train_cli_mesh_without_torchrun_names_it(skeletal_corpus, monkeypatch):
    from mgr_tpu_torch.cli.main import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        main(["train", "skeletal", "--mesh", "2x2", "--device", "cpu", *skeletal_corpus])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 8"):
        main(["train", "skeletal", "--mesh", "2x4", "--device", "cpu", *skeletal_corpus])


# ------------------------------------------------- the device is asked for


def test_default_device_is_cuda_and_never_falls_back(skeletal_corpus, tmp_path):
    """Without --device the CLI and entry() run on the card; on a host
    without one they fail rather than return CPU results."""
    from mgr_tpu_torch import entry as entry_mod
    from mgr_tpu_torch.cli.main import build_parser, main

    for cmd in (["train", "speech"], ["decode", "speech"], ["evaluate", "speech"],
                ["infer", "speech", "x.csv"]):
        assert build_parser().parse_args(cmd).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["train", "skeletal", "--workdir", str(tmp_path), "--epochs", "1",
              *skeletal_corpus])
    assert not os.path.exists(tmp_path / "skeletal_config.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.entry()
