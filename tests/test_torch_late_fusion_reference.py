"""The port's late-fusion model against the benchmark's plain reference
(``benchmark/reference/late_fusion.py``) on seeded weights, on the CPU at a
tiny size: towers of H=8 (speech) and H=6 (skeletal), a fusion layer of
H=4, T=24, float32 compute. The port runs its plain versions.

Tolerances: both sides compute in float32 with the same operands, in
another order (the reference's recurrence and its hand-written adjoint
against the port's plain kernels, CTC's lattice against the port's), so
they agree to float32 rounding: 1e-5 on logits and losses; 1e-5 absolute
on gradients (sums over B x T products: each leaf's largest entry is
2e-3 to 0.5, the gaps read under 1.3e-6); nothing on the frozen towers
(no update touches them: bit for bit); and exact decode decisions (no frame's
probability lies within float32 rounding of a tie or of the threshold on
these seeds).
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import late_fusion as ref_lf
from benchmark.reference import prng as ref_prng
from benchmark.serving import reference_decode

SEED = 2**31 + 91
CELL = "late_fusion-decode-b64"
# The head drawn this much wider: at these widths about a quarter of the frames
# clear 0.5, as 100 gives a third at the published widths.
HEAD_SCALE = 20000.0


def _tiny_config():
    cell = harness.load_cell(CELL, overrides={"pipeline": {
        "maxlen": 24, "compute_dtype": "float32", "fusion_hidden": 4, "max_label_len": 6}})
    sources = copy.deepcopy(cell.config["sources"])
    sources["speech"]["encoder"]["hidden"] = 8
    sources["skeletal"]["encoder"]["hidden"] = 6
    return dict(cell.config, sources=sources), cell


def _build(head_scale=1.0):
    from mgr_tpu_torch.models.zoo import build_model

    config, cell = _tiny_config()
    cell.config = config
    cfg = harness.pipeline_config(cell)
    sources = harness.load_module("traffic", "decode_fusion").source_configs(cell)
    model = build_model(cfg, sources, device="cpu")
    w = harness.make_weights({k: tuple(v.shape) for k, v in model.named_parameters()}, SEED,
                             "cpu", scales={"head.W": head_scale})
    harness.load_weights(model, w)
    ref = ref_lf.Reference(config["pipeline"], w, "cpu", sources=config["sources"])
    return cfg, model, ref, w


def _pair(cfg, B=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, cfg.maxlen, cfg.num_feats), generator=g),
            torch.randn((B, cfg.maxlen, cfg.second_stream_feats), generator=g))


def _key(step=4):
    from mgr_tpu_torch.core import prng

    return (prng.fold_in(prng.fold_name(prng.root_key(SEED), "dropout"), step),
            ref_prng.Key(SEED, ("dropout", step)))


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_the_reference(train):
    cfg, model, ref, _ = _build()
    x = _pair(cfg)
    port_key, ref_key = _key()
    with torch.no_grad():
        port = model.apply_tm(x, train=train, rng=port_key if train else None)
        mine = ref.logits(x, ref_key if train else None)
    assert port.shape == (cfg.maxlen, 3, cfg.nb_classes)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)


def _batch(cfg, B=4):
    xa, xs = _pair(cfg, B, seed=2)
    rng = np.random.default_rng(3)
    n = rng.integers(1, 4, size=B).astype(np.int32)
    ids = rng.integers(1, cfg.nb_classes - 1, size=(B, cfg.max_label_len)).astype(np.int32)
    labels = np.where(np.arange(cfg.max_label_len)[None] < n[:, None], ids, -1).astype(np.int32)
    return {"inputs": xa, "inputs2": xs, "labels": torch.from_numpy(labels),
            "input_length": torch.full((B,), cfg.maxlen - cfg.ctc.trim_frames, dtype=torch.int32),
            "label_length": torch.from_numpy(n)}


@pytest.mark.parametrize("part", ["loss", "fusion", "head", "towers"])
def test_one_train_step_matches_the_reference(part):
    from mgr_tpu_torch.train.step import create_train_state, make_train_step

    cfg, model, ref, w = _build()
    batch = _batch(cfg)
    port_key, ref_key = _key(0)
    state = create_train_state(model)
    state, metrics = make_train_step(model)(state, batch, port_key)
    losses, first = ref.train([batch], [ref_key])
    assert sorted(first) == sorted(k for k in w if k.split(".")[0] in ("fusion", "head"))
    if part == "loss":
        assert abs(float(metrics["loss"]) - losses[0]) <= 1e-5 * abs(losses[0])
    elif part == "towers":
        towers = [k for k in w if k.split(".")[0] in ("speech", "skeletal")]
        assert towers
        for k in towers:
            assert torch.equal(state.params[k].detach(), w[k]), k
            assert torch.equal(ref.p[k], w[k]), k
    else:
        b1 = cfg.optimizer.beta1
        leaves = [k for k in first if k.startswith(part + ".")]
        assert leaves
        for k in leaves:
            g = state.opt_state.mu[k] / (1.0 - b1)
            torch.testing.assert_close(g, first[k], rtol=1e-4, atol=1e-5, msg=k)


def test_decoder_gives_the_reference_best_path():
    from mgr_tpu_torch.decode.decoder import DECODE_SPECS, Decoder

    cfg, model, ref, _ = _build(HEAD_SCALE)
    x = _pair(cfg, B=4, seed=5)
    batch = {"inputs": x[0].numpy(), "inputs2": x[1].numpy(),
             "input_length": np.full(4, cfg.maxlen - 2, np.int32)}
    dec = Decoder.for_model(model, "late_fusion")
    best, emit = dec.decode_fn((batch["inputs"], batch["inputs2"]), None)
    rbest, remit = reference_decode(ref.log_probs(x).numpy(), 0.5)
    assert remit.sum() >= 10  # the frames emit: the collapse and the table are judged
    np.testing.assert_array_equal(best.numpy(), rbest)
    np.testing.assert_array_equal(emit.numpy(), remit)
    out = dec.decode_batches([((0, 1, 2, 3), batch)])
    table = DECODE_SPECS["late_fusion"].vocab
    assert [t for _, t in out] == [[table[int(c)] for c in b[e]] for b, e in zip(rbest, remit)]


def test_a_profiled_forward_opens_each_span_once():
    from torch.profiler import ProfilerActivity, profile

    cfg, model, _, _ = _build()
    x = _pair(cfg, B=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model.apply_tm(x)
    names = [e.name for e in prof.events()]
    assert names.count("mgr.fusion.towers") == 1
    assert names.count("mgr.fusion.layer") == 1
