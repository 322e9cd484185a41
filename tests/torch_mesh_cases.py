"""The cases of the mesh tests of every family
(``tests/test_torch_mesh_families.py``, ``tests/test_torch_mesh_rgb.py``,
``tests/test_torch_mesh_curriculum.py``, ``tests/test_torch_mesh_decode.py``,
and the GSPMD route's ``tests/test_torch_gspmd.py``):
each family's config at test size, its seeded weights and a global
batch; JAX's single-device and shard_map references; one rank launch a
mesh shape for a list of families; and the checks of the port's mesh
step against JAX's, with their tolerances:

  * f32, against JAX's mesh steps: loss rtol 1e-5, eval loss rtol 1e-5,
    the parameters after one step rtol 2e-4 / atol 2e-6; the raw
    gradients against JAX's single-device ``_loss_and_grads`` rtol 1e-4 /
    atol 1e-6 (f32 sums in another order; the exchange itself is exact),
    as ``tests/test_torch_parallel.py`` holds the speech mesh. Late
    fusion's frozen encoders: gradients and Adam moments exactly 0,
    parameters bit-unchanged, as JAX's freeze mask leaves them; the other
    moments rtol 2e-4 / atol 1e-9 (they follow the gradients).
  * bf16 on 2x2, against JAX's 2x2 shard_map step through the Pallas
    kernels in interpret mode (not its single-device step: on a model
    axis rgb's CNN runs its bf16 backward on each direction's half of the
    cotangent apart, where one device runs it on their sum): loss 1e-3
    relative; the gradients, read from Adam's first moment after the step
    ((1 - beta1) times the combined, masked gradient), per leaf within
    1e-2 (fusion) / 5e-2 (rgb: bf16 convs and their transposes) relative
    Frobenius, rgb's CNN biases within 1e-1 (each is the sum of a bf16
    conv output's cotangent over every position and row, and cancels:
    at these shapes each framework's bf16 bias gradients lie 3-9% from its
    own f32 ones, the two frameworks' 1.5-5.3% apart, where the conv
    kernels' lie 0.2% apart and the recurrences' are equal), and the
    frozen leaves' exactly 0; the parameters by
    ``test_torch_train._params_close``'s rule (Adam's first update flips
    where a tiny gradient's sign differs: every entry within twice the
    learning rate, at most 2% of them more than 1e-6 apart), as
    ``tests/test_torch_fusion.py`` and ``tests/test_torch_rgb.py`` hold the
    bf16 step; the 2% share is taken over all of the model's entries,
    since rgb's CNN kernels (100-768 entries) are too small for a share
    per parameter (the per-leaf gradient check covers them).

Noise and dropout are off on the shard_map route: its ranks fold the key
by the data index and draw from the port's streams, which are not JAX's.
The GSPMD route's cases (``gspmd_*``) have them on: its draws are one
process's, so a rank replays JAX's draws (recorded by :func:`jax_draws`
at the global shapes) or draws the port's own, and the step is held to
JAX's GSPMD step and to the port's single-process step.
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mgr_tpu.core import config as cfglib
from mgr_tpu.models import build_model as jbuild
from mgr_tpu.ops import dispatch as jdispatch
from mgr_tpu.parallel import make_mesh as jmake_mesh
from mgr_tpu.parallel import shard_batch as jshard_batch
from mgr_tpu.parallel import shard_params as jshard_params
from mgr_tpu.train import optimizer as jopt
from mgr_tpu.train import step as jstep
from mgr_tpu_torch import bridge
from mgr_tpu_torch.core import config as tconfig
from mgr_tpu_torch.core import prng
from mgr_tpu_torch.models.zoo import build_model as tbuild
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.train import step as tstep
from test_torch_train import _params_close
from torch_jax_draws import jax_bernoulli, jax_key, jax_normal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

TIMEOUT_S = 240
T, B, N = 12, 4, 3
T_RGB, D = 6, 44
MESHES = ((2, 1), (2, 2))
TOL_LOSS_BF16 = 1e-3
TOL_GRAD_BF16 = {"early_fusion": 1e-2, "late_fusion": 1e-2, "rgb": 5e-2}
TOL_GRAD_BF16_CNN_BIAS = 1e-1
OFF = dict(input_noise=0.0, dropout=(0.0, 0.0), output_dropout=0.0)


def _port(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def family_cfg(name, dtype="float32", batch=B):
    """A family's preset at test size with noise and dropout off:
    BiLSTM(8)x2 (late fusion: speech H=8 and skeletal H=6 encoders, a
    BiLSTM(4) fusion layer; rgb: a narrow CNN on 44x44 frames, remat on).
    Returns (config, source configs or None)."""
    common = dict(batch_size=batch, max_label_len=N, compute_dtype=dtype, patience=50)
    enc = cfglib.EncoderConfig(hidden=8, depth=2, **OFF)
    if name == "rgb":
        return cfglib.get_preset("rgb").replace(
            maxlen=T_RGB, encoder=enc, **common,
            cnn=cfglib.CNNConfig(img_dim=D, channels=(4, 6, 8), remat=True)), None
    if name == "early_fusion":
        return cfglib.get_preset(name).replace(maxlen=T, encoder=enc, second_stream_noise=0.0,
                                               **common), None
    if name == "speech":
        return cfglib.get_preset(name).replace(maxlen=T, encoder=enc, **common), None
    sources = {
        "speech": cfglib.get_preset("speech").replace(maxlen=T, max_label_len=N, encoder=enc),
        "skeletal": cfglib.get_preset("skeletal").replace(
            maxlen=T, max_label_len=N, encoder=cfglib.EncoderConfig(hidden=6, depth=2, **OFF)),
    }
    return cfglib.get_preset(name).replace(
        maxlen=T, encoder=enc, fusion_hidden=4, fusion_dropout=0.0,
        fusion_output_dropout=0.0, **common), sources


def family_batch(cfg, seed, n=B):
    """A global batch of ``cfg``'s family: one stream, two, or normalised
    video."""
    rng = np.random.default_rng(seed)
    frames = cfg.maxlen - cfg.ctc.trim_frames
    rgb = cfg.name == "rgb"  # T=6: at most 2 labels over the 4 frames, all valid
    lab_len = rng.integers(1, (2 if rgb else N) + 1, size=n).astype(np.int32)
    lab_len[0] = 0
    labels = np.full((n, N), -1, np.int32)
    for i, k in enumerate(lab_len):
        labels[i, :k] = rng.integers(0, cfg.nb_classes - 1, size=k)
    if rgb:
        x = ((rng.integers(0, 256, (n, cfg.maxlen, D, D, 1)) - 128.0) / 255.0)
        streams = {"inputs": x.astype(np.float32)}
        in_len = np.full((n,), frames, np.int32)
    else:
        streams = {"inputs": rng.standard_normal((n, cfg.maxlen, cfg.num_feats)).astype(
            np.float32)}
        if cfg.second_stream_feats:
            streams["inputs2"] = rng.standard_normal(
                (n, cfg.maxlen, cfg.second_stream_feats)).astype(np.float32)
        in_len = rng.integers(2 * N + 1, frames + 1, size=n).astype(np.int32)
    return {**streams, "labels": labels, "label_length": lab_len, "input_length": in_len}


def port_weights(cfg, sources, seed):
    """The port's seeded init of ``cfg``'s model as a JAX tree of numpy
    arrays (no JAX init compile)."""
    tsources = None if sources is None else {k: _port(v) for k, v in sources.items()}
    return bridge.params_to_numpy(tbuild(_port(cfg), tsources, seed=seed, device="cpu"))


def case(name, dtype="float32", seed=0):
    cfg, sources = family_cfg(name, dtype)
    return {"name": name, "dtype": dtype, "cfg": cfg.to_json(), "jcfg": cfg,
            "sources": None if sources is None else {k: v.to_json() for k, v in sources.items()},
            "jsources": sources, "params": port_weights(cfg, sources, seed),
            "batch": family_batch(cfg, seed + 100)}


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(tree).items()}


def _adam_moments(opt_state):
    """The (mu, nu) trees of optax's Adam inside the JAX optimizer state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    for attr in ("inner_state", "inner_opt_state"):
        if hasattr(opt_state, attr):
            return _adam_moments(getattr(opt_state, attr))
    return None


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jax_state(c):
    params = _to_jax(c["params"])
    return jstep.TrainState(jnp.zeros((), jnp.int32), params,
                            jopt.keras_adam(c["jcfg"].optimizer).init(params))


def jax_reference(c):
    """JAX's single-device raw loss and gradients, and for each mesh its
    shard_map eval loss and one shard_map train step."""
    jmodel = jbuild(c["jcfg"], c["jsources"])
    batch = _to_jax(c["batch"])
    loss1, grads1 = jax.jit(lambda p, b: jstep._loss_and_grads(jmodel, p, b, rng=None))(
        _to_jax(c["params"]), batch)
    out = {"loss1": float(loss1), "grads1": _flat(jax.tree.map(np.asarray, grads1))}
    for shape in MESHES:
        mesh = jmake_mesh(cfglib.MeshConfig(*shape))
        jb = jshard_batch(batch, mesh)
        ev = float(jstep.make_eval_step(jmodel, mesh=mesh)(
            jshard_params(_to_jax(c["params"]), mesh), jb))
        state = _jax_state(c)
        new, m = jstep.make_train_step(jmodel, mesh=mesh)(
            state._replace(params=jshard_params(state.params, mesh)), jb,
            jax.random.key(7), 1.0)
        mu, nu = _adam_moments(new.opt_state)
        out[shape] = {"eval": ev, "loss": float(m["loss"]),
                      "params": _flat(jax.tree.map(np.asarray, new.params)),
                      "mu": _flat(jax.tree.map(np.asarray, mu)),
                      "nu": _flat(jax.tree.map(np.asarray, nu))}
    return out


def jax_bf16_step(c, monkeypatch):
    """JAX's bf16 2x2 shard_map train step through the Pallas kernels in
    interpret mode: its loss, new parameters and Adam's first moment."""
    monkeypatch.setattr(jdispatch, "MODE", "pallas")
    jmodel = jbuild(c["jcfg"], c["jsources"])
    mesh = jmake_mesh(cfglib.MeshConfig(2, 2))
    state = _jax_state(c)
    new, m = jstep.make_train_step(jmodel, mesh=mesh)(
        state._replace(params=jshard_params(state.params, mesh)),
        jshard_batch(_to_jax(c["batch"]), mesh), jax.random.key(7), 1.0)
    monkeypatch.undo()
    mu, _ = _adam_moments(new.opt_state)
    return (float(m["loss"]), _flat(jax.tree.map(np.asarray, new.params)),
            _flat(jax.tree.map(np.asarray, mu)))


def _ranks_payload(cases):
    return [{k: c[k] for k in ("cfg", "sources", "params", "batch")} for c in cases]


def _frozen(c):
    return {k for k in bridge.flatten(c["params"])
            if c["name"] == "late_fusion" and k.split(".")[0] in ("speech", "skeletal")}


def run_meshes(families):
    """One 2x1 launch (the families in f32) and one 2x2 launch (in f32,
    then in bf16), with JAX's references of the f32 cases."""
    f32 = [case(name, seed=i) for i, name in enumerate(families)]
    bf16 = [case(name, "bfloat16", seed=i) for i, name in enumerate(families)]
    out = {(2, 1): run_ranks(ranks.families_rank, 2, ((2, 1), _ranks_payload(f32)),
                             timeout_s=TIMEOUT_S),
           (2, 2): run_ranks(ranks.families_rank, 4, ((2, 2), _ranks_payload(f32 + bf16)),
                             timeout_s=TIMEOUT_S)}
    return {"families": tuple(families), "f32": f32, "bf16": bf16, "ranks": out,
            "jax": {c["name"]: jax_reference(c) for c in f32}}


def check_step(meshes, family, shape):
    """The mesh train step's loss and parameters and the mesh eval loss
    against JAX's mesh steps; every rank on the same replica."""
    i = meshes["families"].index(family)
    c, want = meshes["f32"][i], meshes["jax"][family][shape]
    frozen, init = _frozen(c), _flat(c["params"])
    results = [r[i] for r in meshes["ranks"][shape]]
    for r in results:
        np.testing.assert_allclose(r["step_loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["eval"], want["eval"], rtol=1e-5)
        assert r["params"].keys() == want["params"].keys()
        for k, w in want["params"].items():
            if k in frozen:
                np.testing.assert_array_equal(r["params"][k], init[k], err_msg=k)
                np.testing.assert_array_equal(w, init[k], err_msg=k)
            else:
                np.testing.assert_allclose(r["params"][k], w, rtol=2e-4, atol=2e-6, err_msg=k)
    for r in results[1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, results[0]["params"][k], err_msg=k)


def check_raw_grads(meshes, family, shape):
    """Raw gradients, not parameters after Adam (whose first update is
    -lr * sign(g) and would hide a constant factor such as the 2 of the
    direction exchange's backward)."""
    i = meshes["families"].index(family)
    want, frozen = meshes["jax"][family], _frozen(meshes["f32"][i])
    for r in (r[i] for r in meshes["ranks"][shape]):
        np.testing.assert_allclose(r["loss"], want["loss1"], rtol=1e-5)
        assert r["grads"].keys() == want["grads1"].keys()
        for k, w in want["grads1"].items():
            if k in frozen:  # no backward through a frozen encoder
                assert not r["grads"][k].any(), k
            else:
                np.testing.assert_allclose(r["grads"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def check_calls(meshes, family, shape):
    """2x2: every recurrence through the single-direction wrappers (K5a/K5b
    on the card), a frozen encoder's forward included; 2x1: through the
    two-direction ones (K1/K2)."""
    i = meshes["families"].index(family)
    for r in meshes["ranks"][shape]:
        c = r[i]["calls"]
        one = (c["lstm_tm_streams"], c["lstm_tm_bwd"])
        two = (c["bilstm_tm_streams"], c["bilstm_tm_bwd"])
        if shape[1] == 2:
            assert min(one) > 0 and max(two) == 0, c
        else:
            assert min(two) > 0 and max(one) == 0, c


def check_bf16(meshes, family, monkeypatch):
    """The bf16 2x2 step against JAX's: the loss, Adam's first moment of
    every leaf (the combined gradient it saw) and the parameters."""
    i = meshes["families"].index(family)
    c = meshes["bf16"][i]
    loss, params, mu = jax_bf16_step(c, monkeypatch)
    lr = c["jcfg"].optimizer.learning_rate
    frozen = _frozen(c)
    for r in meshes["ranks"][(2, 2)]:
        got = r[len(meshes["families"]) + i]
        assert abs(got["step_loss"] - loss) <= TOL_LOSS_BF16 * abs(loss)
        assert got["mu"].keys() == mu.keys()
        for k, w in mu.items():
            if k in frozen:
                assert not got["mu"][k].any() and not w.any(), k
            else:
                tol = TOL_GRAD_BF16_CNN_BIAS if k.startswith("cnn.bias") else \
                    TOL_GRAD_BF16[family]
                rel = np.linalg.norm(got["mu"][k] - w) / np.linalg.norm(w)
                assert rel <= tol, (k, rel)
        diff = np.concatenate([np.abs(got["params"][k] - w).ravel() for k, w in params.items()])
        _params_close(diff, np.zeros_like(diff), 2 * lr)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cli(args, procs, cwd):
    """The port's CLI with test-size presets (``torch_parallel_ranks.py``)
    on ``procs`` processes started by torchrun, or in one process; the
    JSON lines it printed."""
    script = os.path.join(ROOT, "tests", "torch_parallel_ranks.py")
    launch = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(procs),
              "--nnodes", "1", "--master-addr", "localhost", "--master-port",
              str(_free_port()), script] if procs > 1 else [sys.executable, script]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run([*launch, *args], cwd=str(cwd), capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


# ------------------------------------------------------------ the GSPMD route

GSPMD_MESHES = ((1, 4, 1), (2, 1, 2), (1, 2, 2), (1, 3, 1))
GSPMD_KEY = prng.fold_in(prng.fold_name(prng.root_key(5), "dropout"), 0)
ON = dict(input_noise=0.5, dropout=(0.4, 0.5), output_dropout=0.5)


def gspmd_cfg(name, dtype="float32"):
    """A family's preset at test size (as :func:`family_cfg`) with noise and
    dropout ON: BiLSTM(8)x2 (H=8: blocks of 2 on a model axis of 4, every
    rank the whole layer on one of 3), early fusion's second stream noisy,
    late fusion's encoders noisy (its skeletal H=6 is no multiple of 4) and
    its fusion layer (H=4) dropped out."""
    cfg, sources = family_cfg(name, dtype)
    enc = dataclasses.replace(cfg.encoder, **ON)
    over = {"encoder": enc}
    if name == "early_fusion":
        over["second_stream_noise"] = 0.3
    if name == "late_fusion":
        over.update(fusion_dropout=0.3, fusion_output_dropout=0.5)
        sources = {k: v.replace(encoder=dataclasses.replace(v.encoder, **ON))
                   for k, v in sources.items()}
    return cfg.replace(**over), sources


def gspmd_case(name, dtype="float32", seed=0):
    cfg, sources = gspmd_cfg(name, dtype)
    return {"name": name, "dtype": dtype, "cfg": cfg.to_json(), "jcfg": cfg,
            "sources": None if sources is None else {k: v.to_json() for k, v in sources.items()},
            "jsources": sources, "params": port_weights(cfg, sources, seed),
            "batch": family_batch(cfg, seed + 100), "key": (GSPMD_KEY.seed, GSPMD_KEY.path),
            "draws": None}


@contextlib.contextmanager
def jax_draws():
    """The port's ``prng.bernoulli`` / ``prng.normal`` drawn by
    ``jax.random`` on the same fold path (``torch_jax_draws.replay_jax_draws``),
    and recorded: yields the dict of (kind, seed, path, shape) -> array
    that ``torch_parallel_ranks.replay_draws`` replays."""
    table, real = {}, (prng.bernoulli, prng.normal)

    def bernoulli(key, p, shape, device="cpu"):
        a = jax_bernoulli(key, p, shape)
        table["bernoulli", key.seed, key.path, tuple(shape)] = a
        return torch.from_numpy(a.copy())

    def normal(key, shape, dtype, device="cpu"):
        a = jax_normal(key, shape)
        table["normal", key.seed, key.path, tuple(shape)] = a
        return torch.from_numpy(a.copy()).to(dtype)

    prng.bernoulli, prng.normal = bernoulli, normal
    try:
        yield table
    finally:
        prng.bernoulli, prng.normal = real


def port_step(c):
    """The port's single-process step on the case: the raw loss and
    gradients, the eval loss, one train step's loss and parameters."""
    model = bridge.load_params(
        tbuild(_port(c["jcfg"]), None if c["jsources"] is None else
               {k: _port(v) for k, v in c["jsources"].items()}, device="cpu"), c["params"])
    key = prng.Key(*c["key"])
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    loss, grads = tstep._loss_and_grads(model, dict(model.named_parameters()), batch, key)
    out = {"loss": float(loss), "grads": {k: g.float().numpy().copy() for k, g in grads.items()},
           "eval": float(tstep.make_eval_step(model)(c["batch"]))}
    state, m = tstep.make_train_step(model)(tstep.create_train_state(model), c["batch"], key, 1.0)
    out.update(step_loss=float(m["loss"]),
               params={k: v.detach().float().numpy().copy() for k, v in state.params.items()})
    return out


def jax_single_grads(c):
    """JAX's single-device raw loss and gradients on the case's key."""
    jmodel = jbuild(c["jcfg"], c["jsources"])
    loss, grads = jax.jit(lambda p, b, r: jstep._loss_and_grads(jmodel, p, b, rng=r))(
        _to_jax(c["params"]), _to_jax(c["batch"]), jax_key(prng.Key(*c["key"])))
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


def jax_gspmd_step(c, shape):
    """JAX's GSPMD train step on a ``shape`` mesh of the virtual CPU
    devices, set up as ``tests/test_sharding.py:62-101`` sets it up
    (parameters by ``shard_params``, the optimizer state replicated, the
    batch by ``shard_batch``): its loss and new parameters."""
    jmodel = jbuild(c["jcfg"], c["jsources"])
    mesh = jmake_mesh(cfglib.MeshConfig(*shape))
    state = _jax_state(c)
    state = state._replace(
        params=jshard_params(state.params, mesh),
        opt_state=jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P()))
                               if hasattr(x, "shape") else x, state.opt_state))
    new, m = jstep.make_train_step(jmodel, mesh=mesh)(
        state, jshard_batch(_to_jax(c["batch"]), mesh), jax_key(prng.Key(*c["key"])), 1.0)
    return float(m["loss"]), _flat(jax.tree.map(np.asarray, new.params))
