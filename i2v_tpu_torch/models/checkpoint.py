"""Flax's msgpack checkpoint format, read and written without flax or msgpack.

The JAX package saves parameter trees with ``flax.serialization`` (its
``msgpack_serialize`` / ``msgpack_restore``); this module reads and writes
the same bytes in pure Python and numpy, so that a machine without either
package loads and writes those files. The format:

  - msgpack's map, array, str, bin, int, float, nil and bool; maps have str
    keys, arrays come back as lists;
  - Flax's extension types: 1 = an ndarray, a packed ``(shape, dtype name,
    C-order buffer)``; 2 = a complex, a packed ``(real, imag)``; 3 = a numpy
    scalar, packed as a 0-d ndarray;
  - an array above ``MAX_CHUNK_SIZE`` bytes (2**30, msgpack's limit on one
    object with a margin) is written as ``{"__msgpack_chunked_array__":
    True, "shape": {"0": …}, "chunks": {"0": …}}`` and joined on reading;
  - a tuple is a ``{"0": …, "1": …}`` map (Flax's state dicts turn tuples
    into these before saving).

A dtype that numpy cannot name by itself (bfloat16, which needs
``ml_dtypes``) raises with its name.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf)} in all")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, ext_hook):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, ext_hook)
        if 0x90 <= b <= 0x9F:
            return [self.value(ext_hook) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",    # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",    # str
                 0xDC: ">H", 0xDD: ">I",                # array
                 0xDE: ">H", 0xDF: ">I",                # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}    # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b >= 0xD9 and b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.value(ext_hook) for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n, ext_hook)
            code = self.unpack(">b")
            return ext_hook(code, self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return ext_hook(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def _map(self, n: int, ext_hook) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(ext_hook)
            out[k] = self.value(ext_hook)
        return out


def _no_ext(code, data):
    raise ValueError(f"unexpected msgpack extension type {code} inside an array header")


def unpackb(data, ext_hook=_no_ext):
    """One msgpack object from ``data`` (bytes-like)."""
    r = _Reader(data)
    out = r.value(ext_hook)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data after the msgpack object")
    return out


def _dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ValueError(f"checkpoint array of dtype {name!r}: numpy cannot name it "
                         "(bfloat16 needs ml_dtypes); convert the checkpoint to float32") from e


def _ndarray(data) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buffer, dtype=_dtype(dtype_name)).reshape(shape, order="C")


def _ext(code: int, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code} in a Flax checkpoint")


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data) -> dict:
    """``flax.serialization.msgpack_restore``: the tree of a checkpoint's
    bytes, arrays as (read-only) numpy arrays over ``data``."""
    return _unchunk(unpackb(data, _ext))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _pack_int(x: int, out: list) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x > 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if x <= hi:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"integer {x} is too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                              (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if x >= lo:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"integer {x} is too small for msgpack")


def _header(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length-prefixed type's header: the fix form up to ``fix_max``, then
    the 8-, 16- and 32-bit forms (``codes``, None where the type has none)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack object of length {n} is too large")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(bytes([fixext[len(data)]]) + struct.pack(">b", code))
    else:
        _header(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(struct.pack(">b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved in a checkpoint")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x, out: list) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        raw = x.encode("utf-8")
        _header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif t is bytes:
        _header(len(x), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(x)
    elif t is list:
        _header(len(x), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif t is dict:
        _header(len(x), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    elif t is complex:
        _pack_ext(_EXT_COMPLEX, packb([x.real, x.imag]), out)
    else:
        raise TypeError(f"cannot save a {t.__name__} in a checkpoint "
                        "(dict, list, str, bytes, int, float, bool, None and numpy only)")


def packb(x) -> bytes:
    """One msgpack object's bytes, as ``msgpack.packb`` gives them (lists
    for arrays; a tuple is not accepted, as under Flax's strict types)."""
    out: list = []
    _pack(x, out)
    return b"".join(out)


def _chunk(tree):
    if isinstance(tree, dict):  # Flax writes a map's keys sorted (a JAX pytree's order)
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        step = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def serialize(tree: dict) -> bytes:
    """``flax.serialization.msgpack_serialize``: a tree of dicts (str keys)
    and numpy leaves → the checkpoint's bytes, Flax's to the byte: keys
    sorted, oversized arrays chunked."""
    return packb(_chunk(tree))
