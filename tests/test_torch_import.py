"""The port stands without JAX: every module (the training and mesh
paths' included) imports with ``jax``, ``flax``, ``optax``, ``msgpack`` and
the JAX package ``mgr_tpu`` blocked, pulls in no pandas, and no source of the package
(nor ``chip_smoke.py``) names JAX, ``mgr_tpu``, a library stand-in for
the hand-written kernels, or torch's own Adam in place of the Keras-parity
one."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mgr_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES
    ]


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack', 'mgr_tpu'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "assert 'pandas' not in sys.modules, 'pandas imported eagerly'\n"
        "from mgr_tpu_torch.cli.main import build_parser\n"
        "build_parser().parse_args(['score', 'a', 'b'])\n"
        "build_parser().parse_args(['train', 'speech', '--epochs', '1'])\n"
        "from mgr_tpu_torch.train import loop, optimizer, step\n"
        "from mgr_tpu_torch.parallel import collectives, mesh, multihost, sharding, spawn\n"
        "build_parser().parse_args(['train', 'speech', '--mesh', '2x2', '--device', 'cpu'])\n"
        "build_parser().parse_args(['train', 'late_fusion', '--from-scratch', '--audio-dir', 'a'])\n"
        "build_parser().parse_args(['curriculum', '--audio-dir', 'a', '--audio-labels', 'b',\n"
        "                           '--skeletal-csv', 'c', '--labels', 'd'])\n"
        "from mgr_tpu_torch.train import curriculum\n"
        "from mgr_tpu_torch.data.datasets import build_early_fusion_dataset\n"
        "from mgr_tpu_torch.data.formats import load_monolithic_audio_csv\n"
        "from mgr_tpu_torch.models.zoo import EarlyFusionModel, LateFusionModel, RGBModel\n"
        "from mgr_tpu_torch.models.layers import CNN, cnn_frontend, cnn_output_dim, init_cnn\n"
        "from mgr_tpu_torch.data.datasets import LazyVideoBatcher, build_rgb_dataset\n"
        "from mgr_tpu_torch.data.formats import list_video_files, load_video_npy\n"
        "build_parser().parse_args(['train', 'rgb', '--data-dir', 'v', '--labels', 'l'])\n"
        "build_parser().parse_args(['infer', 'rgb', 'Sample00001_color.npy'])\n"
        "from mgr_tpu_torch.core import metrics, prng\n"
        "from mgr_tpu_torch.kernels import lstm_scan\n"
        "from mgr_tpu_torch.ops import image, kinematics, mfcc\n"
        "from mgr_tpu_torch.data import (audio_pipeline, labels_pipeline, mixer,\n"
        "                                rgb_pipeline, skeletal_pipeline)\n"
        "build_parser().parse_args(['prepare-audio', '--wav-dir', 'w', '--out-dir', 'o',\n"
        "                           '--device', 'cpu'])\n"
        "build_parser().parse_args(['prepare-skeletal', '--raw-dir', 'r', '--out-csv', 'o',\n"
        "                           '--val-csv', 'v', '--split-at', '403'])\n"
        "build_parser().parse_args(['prepare-rgb', '--video-dir', 'v', '--skeletal-dir', 's',\n"
        "                           '--out-dir', 'o', '--img-dim', '60'])\n"
        "build_parser().parse_args(['mix', '--audio-train', 'a', '--audio-val', 'b',\n"
        "                           '--skeletal-train', 'c', '--skeletal-val', 'd',\n"
        "                           '--train-labels', 'e', '--val-labels', 'f',\n"
        "                           '--out-root', 'g', '--n-moved', '5'])\n"
        "assert 'pandas' not in sys.modules, 'pandas imported by the data preparation'\n"
        "from mgr_tpu_torch.core import msgpack, tracing\n"
        "from mgr_tpu_torch.core.checkpoint import (AsyncCheckpointer, load_jax_train_state,\n"
        "                                           read_jax_checkpoint)\n"
        "from mgr_tpu_torch.train.loop import FitResult, fit\n"
        "from mgr_tpu_torch.train.step import make_indexed_eval_step, make_indexed_train_step\n"
        "assert msgpack.restore(bytes([0x81, 0xa1, 0x61, 0x01])) == {'a': 1}\n"
        "a = build_parser().parse_args(['train', 'speech', '--trace-dir', 't', '--debug-nans',\n"
        "                               '--async-checkpoints', '--cache-dir', 'c'])\n"
        "assert (a.trace_dir, a.debug_nans, a.async_checkpoints, a.cache_dir) == \\\n"
        "    ('t', True, True, 'c')\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_package_level_names_resolve_with_jax_and_pandas_blocked():
    """The JAX package's package-level names have their counterparts, and
    every module (the fastcsv binding, the synthetic fixtures, the example,
    utils included) imports with ``pandas`` blocked too: the GPU machine
    has none."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack', 'pandas', 'mgr_tpu'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import mgr_tpu_torch\n"
        "assert mgr_tpu_torch.config.get_preset('speech').name == 'speech'\n"
        "from mgr_tpu_torch.models import build_model\n"
        "from mgr_tpu_torch.decode import (Decoder, decode_probs, read_mlf, write_mlf,\n"
        "                                  edit_distance, score_sequences)\n"
        "from mgr_tpu_torch.train import (keras_adam, apply_maxnorm, TrainState,\n"
        "                                 create_train_state, make_eval_step,\n"
        "                                 make_predict_step, make_train_step)\n"
        "from mgr_tpu_torch.parallel import make_mesh, shard_batch\n"
        "from mgr_tpu_torch.utils import Timer, tree_count_params, tree_norm\n"
        "from mgr_tpu_torch.utils.trees import tree_equal\n"
        "from mgr_tpu_torch.parallel.collectives import all_gather, ppermute_ring, reduce_scatter\n"
        "from mgr_tpu_torch.data.synthetic import (make_audio_dataset, make_skeletal_dataset,\n"
        "    make_monolithic_audio_dataset, make_rgb_dataset, write_label_csv)\n"
        "from mgr_tpu_torch.data.fastcsv import load_numeric_csv\n"
        "from mgr_tpu_torch.ops.ctc import ctc_loss_reference, ctc_loss_reference_batch\n"
        "from mgr_tpu_torch.examples.synthetic_end_to_end import main, example_config\n"
        "from mgr_tpu_torch.core.metrics import MetricsLogger\n"
        "assert callable(MetricsLogger.step)\n"
        "from mgr_tpu_torch.cli.main import build_parser\n"
        "a = build_parser().parse_args(['curriculum', '--audio-dir', 'a', '--audio-labels', 'b',\n"
        "    '--skeletal-csv', 'c', '--labels', 'd', '--trace-dir', 't', '--debug-nans',\n"
        "    '--async-checkpoints', '--cache-dir', 'x'])\n"
        "assert (a.trace_dir, a.debug_nans, a.async_checkpoints, a.cache_dir) == \\\n"
        "    ('t', True, True, 'x')\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")

@pytest.mark.parametrize(
    "pattern",
    [r"^\s*(import|from)\s+(jax|flax|optax|mgr_tpu)\b", r"torch\.compile",
     r"nn\.LSTM", r"(F|functional)\.ctc_loss\(", r"optim\.Adam",
     r"^\s*(import|from)\s+msgpack\b"],
)
def test_package_sources_avoid(pattern):
    """chip_smoke.py may time ``ctc_loss`` beside K3/K4 as a yardstick,
    inside ``library_ctc_ms`` only; the package never calls it."""
    smoke = SMOKE.read_text().splitlines()
    start = next(i for i, ln in enumerate(smoke, 1) if ln.startswith("def library_ctc_ms("))
    end = next(i for i, ln in enumerate(smoke, 1) if i > start and ln.startswith("def "))
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in SOURCES + [SMOKE]
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
        and not (p == SMOKE and "ctc_loss" in pattern and start < i < end)
    ]
    assert not hits, hits


def test_no_switch_sends_a_cuda_tensor_to_a_plain_version():
    for name in ("kernels/bilstm_tm.py", "kernels/ctc.py", "kernels/lstm_scan.py",
                 "ops/dispatch.py"):
        text = (PKG / name).read_text()
        assert not re.search(r"\btry:|os\.environ|getenv", text), name


def test_each_kernel_source_states_what_it_replaces():
    for cu in sorted((PKG / "csrc").glob("*.cu")):
        text = cu.read_text()
        assert "Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:" in text, cu
        assert "What bounds it on this card" in text and "Design" in text, cu
        assert re.search(r'extern "C" int \w+\(', text), cu


def test_every_kernel_has_a_source_and_a_counter():
    """Each kernel is a C entry of its source under csrc/ (K5a/K5b, one
    direction, and K6a/K6b, the batch-major scan, are further entries of
    K1's and K2's sources), every source holds
    a kernel, and each kernel has a launch counter that chip_smoke.py
    reads."""
    from mgr_tpu_torch.ops import dispatch

    sources = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sorted(dispatch.SOURCES) == sorted(dispatch.KERNELS)
    assert sources == sorted(set(dispatch.SOURCES.values()))
    for name, src in dispatch.SOURCES.items():
        text = (PKG / "csrc" / f"{src}.cu").read_text()
        assert re.search(rf'extern "C" int {name}\(', text), (name, src)
    assert sorted(dispatch.launch_counts()) == sorted(dispatch.KERNELS)
    smoke = SMOKE.read_text()
    assert all(f'"{name}"' in smoke for name in dispatch.KERNELS)


def test_build_is_lazy_and_targets_sm90a():
    from mgr_tpu_torch.kernels import build

    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR == PKG / "_build"
    assert "mgr_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().split()


def test_build_hash_covers_the_shared_headers(tmp_path):
    """A library's name hashes its source and the headers beside it, so
    an edited header rebuilds every library, and an edited source only
    its own."""
    from mgr_tpu_torch.kernels import build

    for p in (PKG / "csrc").iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    names = sorted(p.stem for p in tmp_path.glob("*.cu"))
    before = {n: build.source_digest(n, tmp_path) for n in names}
    assert before == {n: build.source_digest(n) for n in names}
    src = tmp_path / "bilstm_tm_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after_src = {n: build.source_digest(n, tmp_path) for n in names}
    assert [n for n in names if after_src[n] != before[n]] == ["bilstm_tm_fwd"]
    header = tmp_path / "lstm_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = {n: build.source_digest(n, tmp_path) for n in names}
    assert all(after_header[n] != after_src[n] for n in names)


def test_kernel_sources_include_only_headers_beside_them():
    for cu in sorted((PKG / "csrc").glob("*.cu")):
        for inc in re.findall(r'^#include "([^"]+)"', cu.read_text(), re.M):
            assert inc.endswith(".cuh") and (PKG / "csrc" / inc).is_file(), (cu.name, inc)


def test_recurrences_use_tensor_cores_and_a_per_direction_barrier():
    """K1/K2 (and their K5/K6 entries) run their step products as
    mma.sync and meet on a counter per direction, not a grid-wide sync."""
    common = (PKG / "csrc" / "lstm_common.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in common
    assert "ld.acquire.gpu" in common and "fence.acq_rel.gpu" in common
    for name in ("bilstm_tm_fwd", "bilstm_tm_bwd"):
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert '#include "lstm_common.cuh"' in text, name
        assert "mma16816(" in text or "z_partial<" in text, name
        assert "grid.sync" not in text and "cooperative_groups" not in text, name
        assert f'extern "C" int {name}_barrier_words(int B, int groups)' in text, name


def test_ctc_kernels_stage_frames_ahead_and_scatter_without_atomics():
    """K3 and K4 stage their frames into shared memory with asynchronous
    copies (cp.async; K4's alpha rows by bulk copy on an mbarrier) and wait
    only at chunk boundaries; K4 writes d lp with no atomic, so two
    launches give the same bits."""
    copies = (PKG / "csrc" / "async_copy.cuh").read_text()
    assert "cp.async.ca.shared.global" in copies
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in copies
    assert '#include "async_copy.cuh"' in (PKG / "csrc" / "ctc_common.cuh").read_text()
    for name in ("ctc_fwd", "ctc_bwd"):
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert '#include "ctc_common.cuh"' in text, name
        assert "cp_async4(" in text and "cp_async_wait<" in text, name
    bwd = (PKG / "csrc" / "ctc_bwd.cu").read_text()
    assert "bulk_copy(" in bwd and "mbar_wait(" in bwd
    assert not re.search(r"atomic[A-Z]\w*\(|\bred\.|\batom\.", bwd)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
