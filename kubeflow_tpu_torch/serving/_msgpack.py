"""The msgpack subset that flax's ``serialization.to_bytes`` writes and
``msgpack_restore`` reads, without the ``msgpack`` package or flax.

The format (flax 0.12): nested maps with str keys; an array leaf is ext
type 1 whose payload is the msgpack array ``(shape, dtype name, C-order
bytes as bin)``; ext type 3 is a numpy scalar in the same encoding. An
array over ``MAX_CHUNK_SIZE`` bytes is written as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat chunk, ...}}``. A base LM export is 1.9 GB, so
``dump`` writes each array's bytes straight from its buffer and ``load``
reads the file once and hands out ``np.frombuffer`` views of it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, Dict, Mapping

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- writing -------------------------------------------------------------

def _uint_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a sized item: ``fix | n`` when n <= fix_max, else the
    8/16/32-bit length form (``codes`` gives their type bytes; None where
    that width does not exist)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of {n} entries/bytes is too large")


def _map_header(n: int) -> bytes:
    return _uint_header(n, 0x80, 15, (None, 0xDE, 0xDF))


def _array_header(n: int) -> bytes:
    return _uint_header(n, 0x90, 15, (None, 0xDC, 0xDD))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _uint_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _uint_header(n, None, -1, (0xC4, 0xC5, 0xC6))


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, lo in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                          (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
        if v >= lo:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _uint_header(n, None, -1, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _write_array(f: BinaryIO, arr: np.ndarray, code: int) -> None:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize dtype {arr.dtype}")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head = (_array_header(3) + _array_header(arr.ndim)
            + b"".join(_int(d) for d in arr.shape) + _str(arr.dtype.name)
            + _bin_header(arr.nbytes))
    f.write(_ext_header(code, len(head) + arr.nbytes))
    f.write(head)
    f.write(arr.reshape(-1).view(np.uint8))


def _chunked(arr: np.ndarray) -> Dict[str, Any]:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _write(f: BinaryIO, obj: Any) -> None:
    if isinstance(obj, Mapping):
        f.write(_map_header(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            f.write(_str(k))
            _write(f, v)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _write(f, _chunked(obj))
        else:
            _write_array(f, obj, EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        _write_array(f, np.asarray(obj), EXT_NPSCALAR)
    elif obj is None:
        f.write(b"\xc0")
    elif isinstance(obj, bool):
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        f.write(_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        f.write(_str(obj))
    elif isinstance(obj, (list, tuple)):
        f.write(_array_header(len(obj)))
        for v in obj:
            _write(f, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def dump(tree: Any, f: BinaryIO) -> None:
    """Write ``tree`` (nested str-keyed dicts of numpy arrays and
    scalars) to the binary file ``f`` in flax's msgpack layout."""
    _write(f, tree)


# -- reading -------------------------------------------------------------

_SIZED = {  # type byte: (struct format of the length, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_FIXED = {  # type byte: struct format of the value
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf: memoryview, base: int = 0):
        self.buf = buf
        self.i = 0
        self.base = base  # offset of buf in the file, for error messages

    def _take(self, n: int) -> memoryview:
        if self.i + n > len(self.buf):
            raise ValueError(f"msgpack data truncated at offset "
                             f"{self.base + self.i}")
        out = self.buf[self.i:self.i + n]
        self.i += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self, path: str = "") -> Any:
        at = self.base + self.i
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F, path)
        if 0x90 <= t <= 0x9F:
            return [self.read(path) for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _FIXED:
            return self._unpack(_FIXED[t])
        if t in _FIXEXT:
            return self._ext(_FIXEXT[t], path, at)
        if t in _SIZED:
            fmt, kind = _SIZED[t]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return [self.read(path) for _ in range(n)]
            if kind == "map":
                return self._map(n, path)
            return self._ext(n, path, at)
        raise ValueError(f"unknown msgpack type byte 0x{t:02x} at offset "
                         f"{at} ({path or 'root'})")

    def _map(self, n: int, path: str) -> Any:
        out = {}
        for _ in range(n):
            at = self.base + self.i
            k = self.read(path)
            if not isinstance(k, str):
                raise ValueError(f"non-str map key {k!r} at offset {at} "
                                 f"({path or 'root'})")
            out[k] = self.read(f"{path}/{k}" if path else k)
        if _CHUNKED in out:
            return _unchunk(out, path)
        return out

    def _ext(self, n: int, path: str, at: int) -> Any:
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code} at offset "
                             f"{at} ({path or 'root'})")
        inner = _Reader(payload, self.base + self.i - n)
        shape, name, data = inner.read(path)
        if isinstance(name, memoryview):
            name = str(name, "utf-8")
        arr = _array(shape, name, data, path)
        return arr[()] if code == EXT_NPSCALAR else arr


def _array(shape, name: str, data: memoryview, path: str):
    if name == "bfloat16":
        # numpy has no bfloat16: read the bits as uint16 and view them.
        bits = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown array dtype {name!r} at {path or 'root'}")
    return np.frombuffer(data, dtype).reshape(shape)


def _unchunk(d: Dict[str, Any], path: str):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data) -> Any:
    """Decode one msgpack object from ``data`` (bytes-like). Arrays are
    views of ``data`` where it is writable."""
    return _Reader(memoryview(data)).read()


def load(path: str) -> Any:
    """Read the file at ``path`` once into memory and decode it."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view = memoryview(buf)
        n = 0
        while n < len(buf):
            got = f.readinto(view[n:])
            if not got:
                raise ValueError(f"{path}: file shrank while reading")
            n += got
    return unpackb(buf)
