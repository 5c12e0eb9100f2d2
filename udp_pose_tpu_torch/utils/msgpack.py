"""The msgpack files ``flax.serialization`` writes, read and written in
pure Python (the card's machine has neither ``msgpack`` nor ``flax``).

The format is ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``: msgpack maps, strings, ints, floats, bools and nil
(as the ``msgpack`` package packs them with ``use_bin_type=True``: str 8
for 32–255 bytes of text, bin 8/16/32 for bytes, the smallest int and
float64), with numpy arrays as extension type 1 holding the packed
``[shape, dtype name, C-order bytes]`` and numpy scalars as type 3 (the
same payload of a 0-d array).  Arrays over 2**30 bytes are split as flax
splits them (a map marked ``__msgpack_chunked_array__``).
:func:`restore` returns nested dicts of numpy arrays; ``bfloat16``
arrays, which numpy has no type for, come back as float32 (exactly).  :func:`serialize` gives the bytes flax's writer
gives for the same tree of dicts, lists, Python scalars and numpy arrays
(flax copies the tree with ``jax.tree_util``, which sorts each dict's
keys; so does this writer).
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30          # flax's: bytes of one array leaf
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- write
def _pack_int(n, out):
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif n > 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if n <= limit:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if n >= limit:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _pack_len(n, out, fix, fix_max, codes):
    """A header of ``n`` entries: the fix form below ``fix_max``, else
    the first of ``codes`` (8/16/32-bit lengths; None where the type has
    no such form) that holds it."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < (1 << (8 * struct.calcsize(fmt))):
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"{n} entries: too many for msgpack")


def _pack_ext(code, data, out):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    else:
        _pack_len(n, out, 0, 0, (0xC7, 0xC8, 0xC9))
        out.append(code)
    out += data


def _ndarray_payload(arr):
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    return serialize([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) is bytes:
        _pack_len(len(obj), out, 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) is list:
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in sorted(obj.items()):
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r}")


def _chunked(arr):
    """flax's ``_chunk``: an array too large for one leaf as a map of its
    shape and flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _chunk_large(tree):
    if isinstance(tree, dict):
        return {k: _chunk_large(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunked(tree)
    return tree


def serialize(tree) -> bytes:
    """``tree`` as msgpack bytes, as ``flax.serialization.
    msgpack_serialize`` writes it."""
    out = bytearray()
    _pack(_chunk_large(tree), out)
    return bytes(out)


# ------------------------------------------------------------------ read
def _bf16_to_f32(raw):
    bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray(data):
    shape, name, raw = restore(data, raw_strings=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = _bf16_to_f32(raw)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(name))
    return arr.reshape(shape, order="C")


def _ext(code, data):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


class _Reader:
    def __init__(self, data, raw_strings):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_strings = raw_strings

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n):
        raw = bytes(self.take(n))
        return raw if self.raw_strings else raw.decode("utf-8")

    def array(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{b:02x} is not a type this "
                         "reader knows")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes, raw_strings: bool = False):
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: nested dicts (and lists) of numpy arrays and Python
    scalars.  ``raw_strings``: keep strings as bytes."""
    reader = _Reader(data, raw_strings)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


def read_file(path):
    """:func:`restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())


def write_file(path, tree):
    """Write :func:`serialize` of ``tree`` to ``path``."""
    with open(path, "wb") as f:
        f.write(serialize(tree))
