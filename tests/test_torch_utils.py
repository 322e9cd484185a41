"""The port's small modules held against the JAX package's: the NumPy CTC
oracle (to the bit), ``MetricsLogger.step`` (the same record), the tree
helpers and the timer on tensors (``tests/test_utils.py``'s cases), the
batcher's per-process striding (JAX's shards), the generic collectives
over 4 gloo ranks on the CPU (``tests/test_utils.py``'s values), and the
``curriculum`` command line (every flag of JAX's parser).
"""

import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402
from mgr_tpu.cli.main import build_parser as jparser
from mgr_tpu.core.metrics import MetricsLogger as JLogger
from mgr_tpu.data.batcher import Batcher as JBatcher
from mgr_tpu.ops import ctc as jctc
from mgr_tpu.utils import tree_count_params as jcount
from mgr_tpu.utils import tree_norm as jnorm
from mgr_tpu_torch.cli.main import build_parser as tparser
from mgr_tpu_torch.core.metrics import MetricsLogger as TLogger
from mgr_tpu_torch.data.batcher import Batcher as TBatcher
from mgr_tpu_torch.ops import ctc as tctc
from mgr_tpu_torch.parallel.spawn import run_ranks
from mgr_tpu_torch.utils import Timer, tree_count_params, tree_norm
from mgr_tpu_torch.utils.trees import tree_equal

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_oracle_matches_jax_to_the_bit(seed):
    rng = np.random.default_rng(seed)
    B, T, K, N = 4, 12, 6, 4
    logits = rng.standard_normal((B, T, K))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, K - 1, size=(B, N))
    labels[0, 1] = labels[0, 0]  # a repeated label: the lattice's skip is barred
    in_len = np.array([12, 9, 5, 1])
    lab_len = np.array([4, 2, 0, 1])
    want = jctc.ctc_loss_reference_batch(lp, labels, in_len, lab_len)
    got = tctc.ctc_loss_reference_batch(lp, labels, in_len, lab_len)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    assert tctc.ctc_loss_reference(lp[1], labels[1], 9, 2, blank=0) == \
        jctc.ctc_loss_reference(lp[1], labels[1], 9, 2, blank=0)


def test_metrics_logger_step_writes_jax_record(tmp_path):
    records = []
    for name, cls in (("j", JLogger), ("t", TLogger)):
        log = cls(str(tmp_path / name), stamp="speech", stream=io.StringIO())
        log.start_epoch(3)
        log.step(1.25, 4, lr=0.01, step=7)
        log.step(np.float32(0.5), 2)
        assert log._epoch_seqs == 6
        log.close()
        with open(tmp_path / name / "speech_metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            assert r.pop("ts") > 0
        records.append(recs)
    assert records[0] == records[1]
    assert records[1][0] == {"kind": "step", "loss": 1.25, "lr": 0.01, "step": 7}


def test_tree_count_and_norm():
    tree = {"a": torch.ones((2, 3)), "b": {"c": torch.full((4,), 2.0)}}
    assert tree_count_params(tree) == 10
    np.testing.assert_allclose(float(tree_norm(tree)), np.sqrt(6 * 1 + 4 * 4), rtol=1e-6)
    jtree = {"a": jnp.ones((2, 3)), "b": {"c": jnp.full((4,), 2.0)}}
    assert tree_count_params(tree) == jcount(jtree)
    assert float(tree_norm(tree)) == float(jnorm(jtree))
    bf = {"w": torch.full((3,), 3.0, dtype=torch.bfloat16), "skip": None}
    assert tree_count_params(bf) == 3 and float(tree_norm(bf)) == pytest.approx(np.sqrt(27))
    assert float(tree_norm({})) == 0.0


def test_tree_equal():
    a = {"x": torch.arange(3)}
    b = {"x": torch.arange(3)}
    c = {"x": torch.arange(1, 4)}
    assert tree_equal(a, b)
    assert not tree_equal(a, c)
    assert not tree_equal(a, {"y": torch.arange(3)})
    assert not tree_equal(a, {"x": torch.arange(4)})
    assert not tree_equal({"x": [torch.ones(2)]}, {"x": (torch.ones(2),)})
    assert tree_equal({"x": torch.arange(3.0)}, {"x": np.arange(3)})
    assert not tree_equal({"x": torch.tensor([float("nan")])}, {"x": torch.tensor([float("nan")])})


def test_timer():
    with Timer() as t:
        sum(range(1000))
    assert t.seconds >= 0.0


def _batchers(n=16):
    feats = np.arange(n * 4 * 2, dtype=np.float32).reshape(n, 4, 2)
    labels = np.zeros((n, 3), np.int32)
    ll = np.ones((n,), np.int32)
    il = np.full((n,), 4, np.int32)
    ids = list(range(n))
    return (JBatcher(feats, labels, ll, il, ids, ids, []),
            TBatcher(feats, labels, ll, il, ids, ids, []))


@pytest.mark.parametrize("count", [2, 3])
def test_per_process_striding_gives_jax_shards(count):
    jb, tb = _batchers()
    for index in range(count):
        kw = dict(shuffle_seed=1, process_index=index, process_count=count)
        want = list(jb.epoch(2, **kw))
        got = list(tb.epoch(2, **kw))
        assert [c for c, _ in got] == [c for c, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.keys() == w.keys()
            assert all(np.array_equal(g[k], w[k]) for k in g)
        got_rows = [(c, r.tolist()) for c, r in tb.epoch_indices(2, **kw)]
        assert got_rows == [(c, r.tolist()) for c, r in jb.epoch_indices(2, **kw)]
    # tests/test_utils.py's checks: disjoint, interleaved, jointly the full stream.
    shards = [[c for c, _ in tb.epoch(2, shuffle_seed=1, process_index=i, process_count=count)]
              for i in range(count)]
    full = [c for c, _ in tb.epoch(2, shuffle_seed=1)]
    assert sum(shards, []) != full
    assert sorted(map(tuple, sum(shards, []))) == sorted(map(tuple, full))
    flat = [{x for c in s for x in c} for s in shards]
    assert all(flat[i].isdisjoint(flat[j]) for i in range(count) for j in range(i))


def test_collectives_over_four_gloo_ranks():
    world = 4
    out = run_ranks(ranks.collectives_rank, world, timeout_s=300)
    for rank, r in enumerate(out):
        # Each rank gathers the full vector (tests/test_utils.py's all_gather).
        np.testing.assert_array_equal(r["all_gather"], np.arange(2.0 * world))
        np.testing.assert_array_equal(r["all_gather_stacked"],
                                      np.arange(2.0 * world).reshape(world, 2))
        # psum_scatter of ones: every element the group's size.
        np.testing.assert_array_equal(r["reduce_scatter"], np.full(4, float(world)))
        for shift, got in zip((1, -1, 2), r["ring"]):
            np.testing.assert_array_equal(got, [float((rank - shift) % world)])


def _flag_line(parser, cmd):
    """A command line of ``cmd`` giving every optional flag of ``parser``."""
    sub = next(a for a in parser._actions if a.choices and cmd in a.choices).choices[cmd]
    argv = [cmd]
    for a in sub._actions:
        if not a.option_strings or a.dest == "help":
            continue
        flag = a.option_strings[0]
        if a.nargs == 0:
            argv.append(flag)
        elif a.choices:
            argv += [flag, str(list(a.choices)[-1])]
        elif a.type in (int, float):
            argv += [flag, "2"]
        elif a.dest == "mesh":
            argv += [flag, "2x1"]
        else:
            argv += [flag, f"v_{a.dest}"]
    return argv


def test_every_jax_curriculum_flag_parses_on_the_port():
    argv = _flag_line(jparser(), "curriculum")
    want = vars(jparser().parse_args(argv))
    got = vars(tparser().parse_args(argv))
    for k, v in want.items():
        if k != "fn":
            assert got[k] == v, k
    assert {"trace_dir", "debug_nans", "async_checkpoints", "cache_dir"} <= set(want)
    a = tparser().parse_args([
        "curriculum", "--audio-dir", "a", "--audio-labels", "b", "--skeletal-csv", "c",
        "--labels", "d", "--trace-dir", "t", "--debug-nans", "--async-checkpoints",
        "--cache-dir", "x"])
    assert (a.trace_dir, a.debug_nans, a.async_checkpoints, a.cache_dir) == ("t", True, True, "x")
