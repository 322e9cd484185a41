"""The port's C++ CSV reader (``mgr_tpu_torch/native/fastcsv.cpp``, built
at first use by the host C++ compiler) against the JAX package's, bit for
bit: the synthetic audio corpus, decimals beside float32 rounding
midpoints (where ``np.loadtxt`` differs: it rounds through float64),
negative and scientific values, tabs, CR and blank lines, no-header mode,
and the files the parser rejects (ragged rows, an empty cell, no rows),
which go to ``np.loadtxt``'s result or error in both packages. Each test
of ``tests/test_native.py`` has its port here.
"""

import warnings
from decimal import Decimal, localcontext

import numpy as np
import pandas as pd
import pytest

from mgr_tpu.data import fastcsv as jfastcsv
from mgr_tpu.data import formats as jformats
from mgr_tpu_torch.data import fastcsv, formats, synthetic
from mgr_tpu_torch.kernels import build


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The comparisons need the JAX package's native parser, not its
    NumPy fallback (the host has a C++ compiler)."""
    assert jfastcsv.available()


@pytest.fixture()
def csv_file(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(50, 7)).astype(np.float32)
    path = tmp_path / "x.csv"
    header = ",".join(f"c{i}" for i in range(7))
    np.savetxt(path, data, delimiter=",", header=header, comments="", fmt="%.6f")
    return str(path), data


def _midpoint_csv(path, rows, seed):
    """An audio CSV (39 features + file_number) of 25-digit decimals 1e-20
    (relative) above or below float32 rounding midpoints: a float64 parse
    lands on the midpoint itself, and its float32 rounding then goes to
    the even neighbour whichever side the decimal lies."""
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


def test_native_build_and_parse(csv_file):
    path, data = csv_file
    out = fastcsv.load_numeric_csv(path, skip_header=True)
    assert out.shape == data.shape
    np.testing.assert_allclose(out, data, rtol=1e-5, atol=1e-6)
    _same_bits(out, jfastcsv.load_numeric_csv(path, skip_header=True))
    assert list(build.BUILD_DIR.glob("libfastcsv_*.so"))


def test_matches_pandas(csv_file):
    path, _ = csv_file
    out = fastcsv.load_numeric_csv(path, skip_header=True)
    want = pd.read_csv(path).to_numpy(dtype=np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_negative_and_scientific_notation(tmp_path):
    path = tmp_path / "sci.csv"
    path.write_text("a,b\n-1.5e-3,2E+2\n0.25,-7\n")
    out = fastcsv.load_numeric_csv(str(path), skip_header=True)
    np.testing.assert_allclose(out, [[-0.0015, 200.0], [0.25, -7.0]], rtol=1e-6)
    _same_bits(out, jfastcsv.load_numeric_csv(str(path), skip_header=True))


def test_no_header_mode(tmp_path):
    path = tmp_path / "nh.csv"
    path.write_text("1,2\n3,4\n")
    out = fastcsv.load_numeric_csv(str(path), skip_header=False)
    np.testing.assert_array_equal(out, [[1, 2], [3, 4]])
    _same_bits(out, jfastcsv.load_numeric_csv(str(path), skip_header=False))


def test_tabs_cr_and_blank_lines(tmp_path):
    path = tmp_path / "ws.csv"
    path.write_text("a,b,c\r\n\r\n1.5\t, -2 ,3e1\r\n\n\n4,\t5,6\r\n\n")
    out = fastcsv.load_numeric_csv(str(path), skip_header=True)
    np.testing.assert_array_equal(out, [[1.5, -2, 30], [4, 5, 6]])
    _same_bits(out, jfastcsv.load_numeric_csv(str(path), skip_header=True))


def test_numpy_fallback_matches(csv_file):
    path, data = csv_file
    out = fastcsv.numpy_fallback(path, True)
    np.testing.assert_allclose(out, data, rtol=1e-5, atol=1e-6)
    _same_bits(out, jfastcsv._numpy_fallback(path, True))


@pytest.mark.parametrize("text,skip", [
    ("a,b\n1,2\n3,4,5\n", True),     # ragged (rc 3): np.loadtxt raises
    ("a,b,c\n1,,3\n4,5,6\n", True),  # an empty cell (rc 4): np.loadtxt raises
    ("1,2\n3;4\n", False),           # a bad number (rc 4)
    ("a,b\n", True),                 # no rows (rc 2): np.loadtxt's empty array
])
def test_rejected_files_take_the_loadtxt_path_as_in_jax(tmp_path, text, skip):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write(text)
    outcomes = []
    for load in (jfastcsv.load_numeric_csv, fastcsv.load_numeric_csv):
        with warnings.catch_warnings():  # np.loadtxt warns on an empty file
            warnings.simplefilter("ignore")
            try:
                outcomes.append(("ok", load(path, skip_header=skip)))
            except ValueError as exc:
                outcomes.append(("raised", type(exc)))
    (kind_j, j), (kind_t, t) = outcomes
    assert kind_t == kind_j
    if kind_t == "ok":
        _same_bits(t, j)
    else:
        assert t is j


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "NATIVE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"failed for .*broken\.cpp:\n.*error"):
        build.load_host("broken")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_midpoint_values_match_jax_bit_for_bit_where_loadtxt_differs(tmp_path):
    path = str(tmp_path / "audio_1.csv")
    _midpoint_csv(path, 200, seed=17)
    got = formats.load_audio_file_csv(path)
    want = jformats.load_audio_file_csv(path)
    _same_bits(got, want)
    _same_bits(fastcsv.load_numeric_csv(path), jfastcsv.load_numeric_csv(path))
    loadtxt = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float32)[:, :39]
    differ = int((_bits(loadtxt) != _bits(got)).sum())
    assert got.shape == (200, 39) and differ > 0.2 * got.size  # fault b: float64 first


def test_audio_loader_uses_native_path(tmp_path):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(10, 39)).astype(np.float32)
    rows = np.concatenate([feats, np.full((10, 1), 3.0)], axis=1)
    header = ",".join(str(i) for i in range(39)) + ",file_number"
    path = tmp_path / "audio_3.csv"
    np.savetxt(path, rows, delimiter=",", header=header, comments="", fmt="%.6f")
    out = formats.load_audio_file_csv(str(path))
    np.testing.assert_allclose(out, feats, rtol=1e-5, atol=1e-5)
    _same_bits(out, jformats.load_audio_file_csv(str(path)))


@pytest.mark.parametrize("extra", [("file_number",), ("39", "40", "file_number")])
def test_column_selection_matches_jax(tmp_path, extra):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 39 + len(extra))).astype(np.float32)
    path = tmp_path / "audio_9.csv"
    np.savetxt(path, x, delimiter=",", comments="", fmt="%.7g",
               header=",".join([str(i) for i in range(39)] + list(extra)))
    _same_bits(formats.load_audio_file_csv(str(path)), jformats.load_audio_file_csv(str(path)))


def test_synthetic_audio_corpus_matches_jax_bit_for_bit(tmp_path):
    data_dir, _, labels = synthetic.make_audio_dataset(
        str(tmp_path), n_files=4, frames_per_label=30, max_labels=3, seed=5)
    for fid in labels:
        path = f"{data_dir}/audio_{fid}.csv"
        got = formats.load_audio_file_csv(path)
        assert got.shape[1] == 39 and len(got) == 30 * len(labels[fid])
        _same_bits(got, jformats.load_audio_file_csv(path))
