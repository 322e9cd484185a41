"""ctypes binding of the numeric CSV parser ``native/fastcsv.cpp``
(``mgr_tpu/data/fastcsv.py``).

The parser reads each cell with ``strtof``, straight to the nearest
float32, as the JAX package's does. ``np.loadtxt(dtype=float32)`` rounds
through float64 first and gives another float32 for a decimal close to a
float32 rounding midpoint, so the parser is what makes a corpus read here
equal the JAX package's bit for bit. The library is built at first use
by the host C++ compiler (``kernels/build.py::load_host``); a failed
build raises. A file the parser rejects (ragged rows, an empty or
non-numeric cell: any nonzero return code) goes to ``np.loadtxt``, which
parses it or raises, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from mgr_tpu_torch.kernels import build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host("fastcsv")
    lib.fastcsv_load.restype = ctypes.c_int
    lib.fastcsv_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.fastcsv_free.restype = None
    lib.fastcsv_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    return lib


def load_numeric_csv(path: str, skip_header: bool = True) -> np.ndarray:
    """Numeric CSV -> (rows, cols) float32, each cell ``strtof``'s."""
    lib = _lib()
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    rc = lib.fastcsv_load(
        str(path).encode(), int(skip_header),
        ctypes.byref(data), ctypes.byref(rows), ctypes.byref(cols),
    )
    if rc != 0:
        return numpy_fallback(path, skip_header)
    try:
        n = rows.value * cols.value
        out = np.ctypeslib.as_array(data, shape=(n,)).copy()
        return out.reshape(rows.value, cols.value)
    finally:
        lib.fastcsv_free(data)


def numpy_fallback(path: str, skip_header: bool) -> np.ndarray:
    """``np.loadtxt``'s parse of a file the C++ parser rejects."""
    return np.loadtxt(
        path, delimiter=",", skiprows=1 if skip_header else 0,
        dtype=np.float32, ndmin=2,
    )
