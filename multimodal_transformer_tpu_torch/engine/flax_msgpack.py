"""A decoder of the JAX package's msgpack checkpoints, in Python.

The JAX package writes `.ckpt` and `.state` files with
`flax.serialization.msgpack_serialize`; the port reads them without the
msgpack or flax packages.  The decoder covers the msgpack formats those
files use (maps, arrays, str, bin, ints, floats, nil, bool, ext) and flax's
ext types: 1, an ndarray packed as the msgpack array (shape, dtype name, C
bytes), 2, a complex, and 3, a numpy scalar packed as a 0-d ndarray.  flax
splits an array over 2**30 bytes into a "__msgpack_chunked_array__" map;
such a file is refused.
"""

from __future__ import annotations

import struct

import numpy as np

CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not "
                         "a format this decoder reads")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if CHUNKED in out:
            raise ValueError("the file holds a chunked array (an array over "
                             "2**30 bytes, split by flax); this decoder "
                             "does not read chunked arrays")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == 1:
            return _ndarray(data)
        if code == 2:
            re, im = _Reader(data).obj()
            return complex(re, im)
        if code == 3:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data).obj()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # widen the bits to float32 exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def loads(buf: bytes):
    """Decode one msgpack object (the whole buffer)."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return out


def load(path: str):
    with open(path, "rb") as f:
        return loads(f.read())
