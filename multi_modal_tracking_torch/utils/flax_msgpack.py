"""Reader of flax's msgpack checkpoints (`flax.serialization.to_bytes`),
in pure Python: no msgpack package, no JAX.

`restore(data)` decodes what `flax.serialization.msgpack_restore` does:
maps (dicts), arrays (lists), str, bin (bytes), int, float, nil, bool, and
flax's extension types
  1  ndarray: msgpack (shape, dtype name, C-order bytes) -> numpy array;
     bfloat16, which numpy lacks, becomes a torch.bfloat16 tensor of the
     same bits;
  3  numpy scalar: the same payload -> a numpy scalar.
Type 2 (complex) raises, and so does flax's chunked form of arrays over
2**30 bytes (`__msgpack_chunked_array__`): no flagship leaf comes near it.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("flax msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map_(n)
            return self.ext(n)
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"flax msgpack: unsupported type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _array(payload: bytes):
    """flax's ndarray payload: msgpack (shape, dtype name, bytes)."""
    r = _Reader(payload, raw_str=True)
    shape, name, buf = r.value()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape, order="C")
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _array(payload)
    if code == _EXT_NPSCALAR:
        a = _array(payload)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    if code == _EXT_COMPLEX:
        raise ValueError("flax msgpack: complex leaves (ext type 2) are not supported")
    raise ValueError(f"flax msgpack: unknown ext type {code}")


def _reject_chunked(tree) -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError("flax msgpack: chunked arrays (leaves over 2**30 bytes) are "
                             "not supported")
        for v in tree.values():
            _reject_chunked(v)


def restore(data: bytes) -> Any:
    """Decode flax msgpack bytes to dicts, lists and numpy leaves."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"flax msgpack: {len(r.buf) - r.pos} trailing bytes")
    _reject_chunked(out)
    return out
