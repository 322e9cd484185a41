"""A msgpack reader for the checkpoints the JAX package writes.

Written from the msgpack specification
(https://github.com/msgpack/msgpack/blob/master/spec.md), so the port
needs neither ``msgpack`` nor ``flax``. It covers the subset
``flax.serialization.msgpack_serialize`` writes:

  * nil, bool, ints, floats, str, bin, arrays and maps, in all their
    fix, 8, 16, 32 (and 64-bit number) forms;
  * flax's ext types: 1 = ndarray and 3 = numpy scalar, each a msgpack
    array ``[shape, dtype name, raw C-order bytes]``, and 2 = complex, a
    packed ``[real, imag]``;
  * flax's chunked arrays (arrays above 2**30 bytes): a map holding
    ``__msgpack_chunked_array__``, its ``shape`` and its flat ``chunks``,
    each keyed "0", "1", ...; :func:`restore` reassembles them.

Arrays come back as numpy arrays, except ``bfloat16`` (numpy has no such
dtype): a ``torch.bfloat16`` view of the uint16 bytes. Any other ext code
or dtype, a truncated buffer, trailing bytes or the unused byte 0xc1
raise ``ValueError`` naming what was found: nothing is skipped.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
DTYPES = frozenset({
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "complex64", "complex128", "bfloat16",
})

ExtHook = Callable[[int, bytes], Any]


class _Reader:
    def __init__(self, data: bytes, ext_hook: Optional[ExtHook]):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def ext(self, n: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack: ext type {code} with no reader for it")
        return self.ext_hook(code, payload)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            at = self.pos
            key = self.value()
            if isinstance(key, (dict, list)):
                raise ValueError(f"msgpack: a map key at offset {at} is a {type(key).__name__}")
            out[key] = self.value()
        return out

    def value(self) -> Any:
        at = self.pos
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8/16/32/64
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {at} begins no value")


def unpackb(data: bytes, ext_hook: Optional[ExtHook] = None) -> Any:
    """The one msgpack value ``data`` holds; ``ext_hook(code, payload)``
    reads ext types (without one, an ext type raises)."""
    r = _Reader(data, ext_hook)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the value")
    return out


def _ndarray(payload: bytes):
    """flax's ndarray payload: a packed [shape, dtype name, C-order bytes]."""
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError(f"msgpack: an ndarray payload is {type(fields).__name__} "
                         f"{fields!r:.80}, not [shape, dtype, bytes]")
    shape, name, raw = fields
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    if name not in DTYPES:
        raise ValueError(f"msgpack: ndarray dtype {name!r} is not one the reader knows "
                         f"({sorted(DTYPES)})")
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
        raise ValueError(f"msgpack: ndarray shape {shape!r}")
    if not isinstance(raw, bytes):
        raise ValueError(f"msgpack: ndarray data is a {type(raw).__name__}, not bin")
    dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(raw) != want:
        raise ValueError(f"msgpack: a {name} ndarray of shape {tuple(shape)} holds "
                         f"{want} bytes, the payload {len(raw)}")
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def flax_ext(code: int, payload: bytes) -> Any:
    """flax's ext types (``flax/serialization.py::_MsgpackExtType``)."""
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        re_im = unpackb(payload)
        if not (isinstance(re_im, list) and len(re_im) == 2):
            raise ValueError(f"msgpack: a complex payload is {re_im!r:.80}, not [real, imag]")
        return complex(*re_im)
    raise ValueError(f"msgpack: ext type {code} is not one flax writes "
                     f"(1 ndarray, 2 complex, 3 numpy scalar)")


def _unchunk(d: dict):
    def ordered(m, what):
        if not (isinstance(m, dict) and set(m) == {str(i) for i in range(len(m))}):
            raise ValueError(f"msgpack: a chunked array's {what} is {m!r:.80}")
        return [m[str(i)] for i in range(len(m))]

    shape, chunks = ordered(d.get("shape"), "shape"), ordered(d.get("chunks"), "chunks")
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if not isinstance(x, dict):
        return x
    if CHUNKED in x:
        return _unchunk(x)
    return {k: _unchunk_tree(v) for k, v in x.items()}


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree ``data`` holds, with
    flax's ext types read and chunked arrays reassembled."""
    return _unchunk_tree(unpackb(data, ext_hook=flax_ext))
