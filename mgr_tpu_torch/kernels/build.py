"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` into ``mgr_tpu_torch/_build/lib<name>_<hash>.so``
(the hash is of the source and the shared headers ``csrc/*.cuh``, so an
edited kernel or header is rebuilt) and loaded
with ``ctypes``. Only the repository's sources are compiled; nothing is
downloaded. The build needs the CUDA toolkit, which the GPU machine has
and a CPU-only host does not: nothing here runs at import time.
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
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<name>.cu`` and every header beside it
    (``csrc/*.cuh``): an edited header rebuilds the libraries that may
    include it."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{_logs[name]}")
    os.replace(tmp, out)
    return out


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


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build ``names`` with one nvcc process each, all started together,
    then load them."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_compile, names))
    return {name: load(name) for name in names}


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from this process's build of ``name``, or "" if it was cached."""
    return _logs.get(name, "")


def check(lib: ctypes.CDLL, name: str, err: int, entry: Optional[str] = None) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` (``entry``, default
    ``name``) returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"CUDA kernel {entry or name} failed: error {err} ({msg})")
