"""Build and load the hand-written CUDA kernels and the host C++ library.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` into ``mgr_tpu_torch/_build/lib<name>_<hash>.so``
(the hash is of the source and the shared headers ``csrc/*.cuh``, so an
edited kernel or header is rebuilt) and loaded
with ``ctypes``. Only the repository's sources are compiled; nothing is
downloaded. The build needs the CUDA toolkit, which the GPU machine has
and a CPU-only host does not: nothing here runs at import time.

``native/<name>.cpp`` (the CSV parser) is host code: :func:`load_host`
builds it the same way with the host C++ compiler (``c++ -O3 -shared
-fPIC``), on any host, into ``_build/lib<name>_<hash>.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
NATIVE = PACKAGE / "native"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "mgr_tpu_torch/csrc at first use"
    )


def host_cxx() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler (c++ or g++) on PATH: the CSV parser is built "
        "from mgr_tpu_torch/native at first use"
    )


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<name>.cu`` and every header beside it
    (``csrc/*.cuh``): an edited header rebuilds the libraries that may
    include it."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def _build(name: str, src: Path, digest: str, compiler: Sequence[str]) -> Path:
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [*compiler, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler[0]} failed for {src}:\n{_logs[name]}")
    os.replace(tmp, out)
    return out


def _compile(name: str) -> Path:
    return _build(name, CSRC / f"{name}.cu", source_digest(name), (nvcc(), *NVCC_FLAGS))


def library_path(name: str) -> Path:
    """The built library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        return _compile(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_compile(name)))
        return _libs[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built by the host C++
    compiler if needed (the hash is of the source); a failed build raises
    with the compiler's output."""
    with _lock:
        if name not in _libs:
            src = NATIVE / f"{name}.cpp"
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
            _libs[name] = ctypes.CDLL(
                str(_build(name, src, digest, (host_cxx(), *HOST_CXX_FLAGS))))
        return _libs[name]


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build ``names`` with one nvcc process each, all started together,
    then load them."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_compile, names))
    return {name: load(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    from this process's build of ``name``, or "" if it was cached."""
    return _logs.get(name, "")


def check(lib: ctypes.CDLL, name: str, err: int, entry: Optional[str] = None) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` (``entry``, default
    ``name``) returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"CUDA kernel {entry or name} failed: error {err} ({msg})")
