"""Reader of flax's ``.msgpack`` checkpoints, in plain Python and numpy.

The JAX package's Trainer writes ``best.msgpack`` / ``last.msgpack``
through ``flax.serialization.msgpack_serialize``: a msgpack map
``{"params", "opt_state", "step", "best_loss"}`` (``None`` entries
stripped) whose array leaves are msgpack extension objects.  This module
decodes that subset of msgpack without the ``msgpack`` package (the card's
machine has none):

  * maps, arrays, str, bin, ints, floats, nil and bools;
  * flax's extension types (``flax/serialization.py::_MsgpackExtType``):
    1 = ndarray, itself a msgpack array ``(shape, dtype name, C-order
    bytes)``; 2 = a native complex, ``(real, imag)``; 3 = a numpy scalar,
    packed as a 0-d ndarray;
  * ``bfloat16`` by its name: read as uint16 and returned as a
    ``torch.bfloat16`` tensor (numpy has no bfloat16); every other dtype is
    a numpy array;
  * flax's chunked leaves (arrays over 2**30 bytes, written as
    ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``)
    are reassembled.

Anything else (timestamps, other extension types) raises ``ValueError``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["load_msgpack", "unpackb"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# type byte -> struct format of a fixed-size scalar
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> byte width of the length field
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str objects as bytes (flax's inner ndarray tuples)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _SCALARS:
            fmt = _SCALARS[t]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if t in _BIN:
            return bytes(self.take(self.uint(_BIN[t])))
        if t in _STR:
            return self.string(self.uint(_STR[t]))
        if t in _ARRAY:
            return [self.value() for _ in range(self.uint(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.uint(_MAP[t]))
        if t in _EXT:
            n = self.uint(_EXT[t])
            return self.ext(self.take(1)[0], n)
        if t in _FIXEXT:
            return self.ext(self.take(1)[0], _FIXEXT[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        code = code - 0x100 if code >= 0x80 else code  # the type is a signed byte
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _ndarray(data: bytes):
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buffer = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).reshape(shape).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Reassemble flax's chunked leaves, in place."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = _as_tuple(tree["shape"])
            chunks = _as_tuple(tree["chunks"])
            if any(isinstance(c, torch.Tensor) for c in chunks):
                return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for key, value in tree.items():
            tree[key] = _unchunk(value)
    return tree


def _as_tuple(d: dict) -> Tuple:
    """flax's tuple-as-dict ({"0": x, "1": y, ...})."""
    return tuple(d[str(i)] for i in range(len(d)))


def unpackb(data: bytes, raw: bool = False):
    """Decode one msgpack object; ``raw`` leaves str objects as bytes."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the object")
    return out


def load_msgpack(path) -> Any:
    """The tree of a flax ``.msgpack`` file, chunked leaves reassembled
    (``flax.serialization.msgpack_restore``)."""
    return _unchunk(unpackb(Path(path).read_bytes()))
