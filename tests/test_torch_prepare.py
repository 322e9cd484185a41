"""The port's data preparation (``prepare-skeletal``, ``prepare-audio``,
``prepare-rgb``, ``mix`` and the label pipeline) held against the JAX
package's: the same raw recordings (the fixtures of ``tests/test_cli.py``:
Kinect CSVs, WAVs, ``.npy``/``.mp4`` videos, monolithic CSVs, plus
annotation files) through both CLIs, the port's on the CPU.

What must agree, and how closely:
  * the ids written and the split each id goes to, the headers, and the
    printed JSON line: exactly;
  * skeletal CSVs: 2e-6 absolute (``%.6f`` text of f32 features whose
    integer columns agree exactly and whose angles differ by an ulp);
  * audio CSVs: the MFCC tolerance, rtol 1e-4 / atol 1e-3;
  * ROI ``.npy``: equal, except where the f32 crop lies within 1e-3 of an
    integer (the uint8 conversion truncates, so an ulp there moves it by 1);
  * ``mix``: every output parses to the same arrays, exactly (the port
    copies the input's text, pandas rewrites it);
  * label CSVs, ``parse_label_file`` and ``frame_labels``: exactly.
"""

import contextlib
import io
import json
import os
import wave

import numpy as np
import pytest
import torch

from mgr_tpu.cli.main import main as jcli
from mgr_tpu.data import labels_pipeline as jlabels
from mgr_tpu.data import rgb_pipeline as jrgb
from mgr_tpu_torch.cli.main import main as tcli
from mgr_tpu_torch.data import formats as tformats
from mgr_tpu_torch.data import labels_pipeline as tlabels
from mgr_tpu_torch.data import mixer as tmixer
from mgr_tpu_torch.data import rgb_pipeline as trgb
from mgr_tpu_torch.data import synthetic
from mgr_tpu_torch.data.skeletal_pipeline import KINECT_COLUMNS

torch.set_num_threads(1)


def _run(cli, argv):
    """A CLI's return code and its last printed JSON line."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _both(argv_of, tmp_path):
    """Run ``argv_of(out_root)`` through the JAX CLI and the port's (on the
    CPU) into two roots; returns the two roots."""
    roots = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        root = tmp_path / name
        root.mkdir()
        argv = argv_of(root)
        rc, line = _run(cli, argv + (extra if argv[0].startswith("prepare") else []))
        assert rc == 0
        roots[name] = (root, line)
    assert roots["jax"][1] == roots["torch"][1]
    return roots["jax"][0], roots["torch"][0]


def _header(path):
    with open(path) as f:
        return f.readline().strip()


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _write_kinect(path, T, rng, *, corrupt=None, drop=None, rest_zero=False):
    cols = ["frame"] + [c for c in KINECT_COLUMNS if c != drop]
    lines = [",".join(cols)]
    for t in range(T):
        cells = [str(t)]
        for c in cols[1:]:
            x, y = int(rng.integers(0, 700)), int(rng.integers(0, 520))  # some past the frame
            if rest_zero and t % 3 == 0 and c in ("hip_center", "shoulder_center"):
                x = y = 0
            cells.append(f"[{x} {y}]")
        if corrupt is not None and t == corrupt:
            cells[1] = "[oops]"
        lines.append(",".join(cells))
    path.write_text("\n".join(lines) + "\n")


def test_prepare_skeletal_matches_jax_cli(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    for fid, T in ((1, 12), (2, 30), (405, 17), (406, 8)):
        _write_kinect(raw / f"Sample{fid:05d}_skel.csv", T, rng)
    _write_kinect(raw / "Sample00003_skel.csv", 10, rng, corrupt=4)  # a cell that fails to parse
    _write_kinect(raw / "Sample00004_skel.csv", 10, rng, drop="left_hand")  # a missing joint
    _write_kinect(raw / "Sample00005_skel.csv", 0, rng)  # a header and no frame
    (raw / "notes.txt").write_text("not a video\n")

    def argv(root):
        return ["prepare-skeletal", "--raw-dir", str(raw), "--out-csv", str(root / "train.csv"),
                "--val-csv", str(root / "val.csv"), "--split-at", "403"]

    j, t = _both(argv, tmp_path)
    for name, ids in (("train.csv", {1, 2}), ("val.csv", {405, 406})):
        assert _header(t / name) == _header(j / name)
        got, want = _table(t / name), _table(j / name)
        assert set(got[:, -1].astype(int)) == ids == set(want[:, -1].astype(int))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _write_wav(path, samples, rate, width, channels):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def test_prepare_audio_matches_jax_cli(tmp_path):
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    for fid in (3, 8):  # test_cli's fixture: 1 s of 16 kHz 16-bit mono
        _write_wav(wavs / f"Sample{fid:05d}_audio.wav",
                   (3000 * rng.standard_normal(16000)).astype(np.int16), 16000, 2, 1)
    _write_wav(wavs / "Sample00011_audio.WAV",  # 8-bit stereo at 8 kHz: another config
               rng.integers(0, 256, size=2 * 6000).astype(np.uint8), 8000, 1, 2)
    _write_wav(wavs / "Sample00012_audio.wav",
               (2e8 * rng.standard_normal(9000)).astype("<i4"), 16000, 4, 1)
    _write_wav(wavs / "other.wav", np.zeros(400, np.int16), 16000, 2, 1)  # no id: skipped

    def argv(root):
        return ["prepare-audio", "--wav-dir", str(wavs), "--out-dir", str(root / "feat")]

    j, t = _both(argv, tmp_path)
    names = sorted(os.listdir(j / "feat"))
    assert names == sorted(os.listdir(t / "feat")) == [
        "audio_11.csv", "audio_12.csv", "audio_3.csv", "audio_8.csv"]
    for name in names:
        assert _header(t / "feat" / name) == _header(j / "feat" / name)
        got, want = _table(t / "feat" / name), _table(j / "feat" / name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert tformats.load_audio_file_csv(t / "feat" / "audio_3.csv").shape == (98, 39)


def _near_integer(x, tol=1e-3):
    return np.abs(x - np.round(x)) < tol


def _write_rgb_fixture(tmp_path):
    videos, skel = tmp_path / "vids", tmp_path / "skel"
    videos.mkdir()
    skel.mkdir()
    rng = np.random.default_rng(0)
    T = 6
    yy, xx = np.mgrid[0:480, 0:640]
    base = 120 + 80 * np.sin(xx / 29.0) * np.cos(yy / 41.0)
    for fid, shape_4d in ((2, False), (5, True), (9, False)):
        frames = np.clip(base[None] + rng.integers(-30, 31, size=(T, 480, 640)), 0,
                         255).astype(np.uint8)
        np.save(videos / f"Sample{fid:05d}_color.npy", frames[..., None] if shape_4d else frames)
    # 2: test_cli's track; 5: a short track (edge-padded) with (0, 0) rows
    # (the fallback box); 9: no Kinect CSV (skipped).
    lines = [",".join(["frame"] + list(KINECT_COLUMNS))]
    lines += [",".join([str(i)] + [f"[{320 + i} {240 + i}]"] * len(KINECT_COLUMNS))
              for i in range(T)]
    (skel / "Sample00002_skel.csv").write_text("\n".join(lines) + "\n")
    _write_kinect(skel / "Sample00005_skel.csv", T - 2, rng, rest_zero=True)
    return videos, skel


def test_prepare_rgb_matches_jax_cli(tmp_path):
    videos, skel = _write_rgb_fixture(tmp_path)

    def argv(root):
        return ["prepare-rgb", "--video-dir", str(videos), "--skeletal-dir", str(skel),
                "--out-dir", str(root / "rois"), "--img-dim", "60"]

    j, t = _both(argv, tmp_path)
    names = sorted(os.listdir(j / "rois"))
    assert names == sorted(os.listdir(t / "rois")) == ["Sample00002_color.npy",
                                                       "Sample00005_color.npy"]
    from mgr_tpu.data.skeletal_pipeline import parse_kinect_csv

    for name in names:
        got, want = np.load(t / "rois" / name), np.load(j / "rois" / name)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (6, 60, 60, 1)
        joints = parse_kinect_csv(str(skel / name.replace("_color.npy", "_skel.csv")))
        crops = jrgb.extract_video(str(videos / name), joints["hip"], joints["shc"], 60)
        differ = got != want
        assert not (differ & ~_near_integer(crops)).any()
        assert differ.mean() < 1e-2


def test_extract_video_float_crops_match_jax(tmp_path):
    """The f32 crops before the uint8 conversion, for the short, partly
    invalid track: 1e-3 on the 0-255 scale."""
    videos, skel = _write_rgb_fixture(tmp_path)
    from mgr_tpu.data.skeletal_pipeline import parse_kinect_csv

    joints = parse_kinect_csv(str(skel / "Sample00005_skel.csv"))
    path = str(videos / "Sample00005_color.npy")
    got = trgb.extract_video(path, joints["hip"], joints["shc"], 60, device="cpu")
    want = jrgb.extract_video(path, joints["hip"], joints["shc"], 60)
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 60, 60, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_mp4_video_matches_jax_when_opencv_is_there(tmp_path, monkeypatch):
    """An ``.mp4`` decodes through OpenCV on both sides and gives the same
    crops; without OpenCV both refuse it."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "Sample00007_color.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20, (640, 480))
    rng = np.random.default_rng(3)
    for _ in range(4):
        writer.write(rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8))
    writer.release()
    hip = np.tile(np.float32([[330, 300]]), (4, 1))
    shc = np.tile(np.float32([[320, 140]]), (4, 1))
    got = trgb.extract_video(path, hip, shc, 60, device="cpu")
    np.testing.assert_allclose(got, jrgb.extract_video(path, hip, shc, 60), rtol=0, atol=1e-3)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    for fn in (trgb._load_video_frames, jrgb._load_video_frames):
        with pytest.raises(RuntimeError, match="OpenCV"):
            fn(path)


def _mix_fixture(tmp_path):
    """test_cli.py::test_mix_command's corpus: monolithic train/val audio
    and skeletal CSVs and label CSVs."""
    from mgr_tpu.data.formats import SKELETAL_FEATURES

    rng = np.random.default_rng(0)

    def mono(ids, path, frames, width, names):
        rows = [np.concatenate([rng.normal(size=(frames, width)).astype(np.float32),
                                np.full((frames, 1), fid, np.float32)], axis=1) for fid in ids]
        np.savetxt(path, np.concatenate(rows), delimiter=",",
                   header=",".join(names) + ",file_number", comments="", fmt="%.4f")

    train_ids, val_ids = list(range(1, 11)), list(range(401, 421))
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("at", "av", "st", "sv", "lt", "lv")}
    audio_names = [str(i) for i in range(39)]
    mono(train_ids, paths["at"], 6, 39, audio_names)
    mono(val_ids, paths["av"], 6, 39, audio_names)
    mono(train_ids, paths["st"], 4, 20, SKELETAL_FEATURES)
    mono(val_ids, paths["sv"], 4, 20, SKELETAL_FEATURES)
    synthetic.write_label_csv(paths["lt"], {i: [1, 2] for i in train_ids})
    synthetic.write_label_csv(paths["lv"], {i: [3] if i % 2 else [4, 5, 6] for i in val_ids})
    return paths


@pytest.mark.parametrize("n_moved", [5, 95])
def test_mix_matches_jax_cli(tmp_path, n_moved):
    p = _mix_fixture(tmp_path)

    def argv(root):
        return ["mix", "--audio-train", p["at"], "--audio-val", p["av"],
                "--skeletal-train", p["st"], "--skeletal-val", p["sv"],
                "--train-labels", p["lt"], "--val-labels", p["lv"],
                "--out-root", str(root / "mixed"), "--n-moved", str(n_moved)]

    j, t = _both(argv, tmp_path)
    j, t = j / "mixed", t / "mixed"
    for name in ("training.csv", "validation.csv"):
        assert _header(t / name) == _header(j / name)
        got, want = tformats.load_label_csv(t / name), tformats.load_label_csv(j / name)
        assert list(got.items()) == list(want.items())
    for sub in ("train_audio", "val_audio"):
        names = sorted(os.listdir(j / sub))
        assert names == sorted(os.listdir(t / sub))
        for name in names:
            assert _header(t / sub / name) == _header(j / sub / name)
            np.testing.assert_array_equal(_table(t / sub / name), _table(j / sub / name))
    for name in ("Training_set_skeletal.csv", "Validation_set_skeletal.csv"):
        assert _header(t / name) == _header(j / name)
        np.testing.assert_array_equal(_table(t / name), _table(j / name))


def test_sample_validation_files_matches_jax():
    from mgr_tpu.data import mixer as jmixer

    for n, k, seed in ((20, 5, 10), (150, 95, 10), (7, 95, 3)):
        ids = list(range(400, 400 + n))
        assert tmixer.sample_validation_files(ids, k, seed) == \
            jmixer.sample_validation_files(ids, k, seed)


LABEL_FILES = {
    "Sample00001_data_labels.csv": "vattene,0,10,0,40\nok 0 41 0 80\nfame,0,81,0,120\n",
    "Sample00002_data_labels.csv": "basta 5 30\nunknown 31 50\nvieniqui 51 99\n\n",
    "Sample00010_data_labels.csv": "sonostufo,1,-3,2,7\ncheduepalle,1,2,3,4,5\n",
    "Sample00003_notes.txt": "ignored\n",
    "readme.csv": "no id: ignored\n",
}


def test_build_label_csv_and_frame_labels_match_jax(tmp_path):
    label_dir = tmp_path / "labels"
    label_dir.mkdir()
    for name, text in LABEL_FILES.items():
        (label_dir / name).write_text(text)
    out_t, out_j = tmp_path / "t.csv", tmp_path / "j.csv"
    got = tlabels.build_label_csv(str(label_dir), str(out_t))
    want = jlabels.build_label_csv(str(label_dir), str(out_j))
    assert got == want and list(got) == [1, 2, 10]
    assert out_t.read_bytes() == out_j.read_bytes()
    rng = np.random.default_rng(0)
    for name in sorted(n for n in LABEL_FILES if "data_labels" in n):
        path = str(label_dir / name)
        entries = tlabels.parse_label_file(path)
        assert entries == jlabels.parse_label_file(path)
        inactive = rng.random(130) < 0.2
        for T, mask in ((130, None), (130, inactive), (60, inactive), (5, None)):
            np.testing.assert_array_equal(tlabels.frame_labels(T, entries, mask),
                                          jlabels.frame_labels(T, entries, mask))
        assert tlabels.sequence_labels(entries) == jlabels.sequence_labels(entries)


def test_a_bad_label_row_is_refused_by_both(tmp_path):
    path = tmp_path / "Sample00001_data_labels.csv"
    path.write_text("vattene 12\n")
    for fn in (tlabels.parse_label_file, jlabels.parse_label_file):
        with pytest.raises(ValueError, match="bad label row"):
            fn(str(path))


@pytest.mark.parametrize("cmd", [
    ["prepare-audio", "--wav-dir", "w", "--out-dir", "o"],
    ["prepare-skeletal", "--raw-dir", "r", "--out-csv", "o.csv"],
    ["prepare-rgb", "--video-dir", "v", "--skeletal-dir", "s", "--out-dir", "o"],
])
def test_prepare_commands_refuse_cuda_without_a_card(cmd, monkeypatch):
    """The default ``--device cuda`` on a host without a card exits, naming
    ``--device cpu``; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli(cmd)
