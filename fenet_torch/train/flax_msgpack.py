"""fenet's checkpoint stream without flax or msgpack: a reader and writer for
the subset of msgpack that ``flax.serialization.to_bytes`` emits.

A flax ``.ckpt`` file is the msgpack of a tree of str-keyed maps whose
leaves are arrays, numpy scalars and Python scalars:

- an array is ExtType 1, whose payload is the msgpack of ``(shape,
  dtype.name, raw C-order bytes)``; a numpy scalar is ExtType 3 with the
  same payload (0-d); ExtType 2 is a Python complex, which no fenet tree
  holds and which raises here;
- an array above :data:`MAX_CHUNK_SIZE` bytes is a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat chunk, ...}}``;
- the dtype name ``bfloat16`` is ``torch.bfloat16`` (numpy cannot name it
  without ml_dtypes).

:func:`load` maps the file copy-on-write and hands out arrays that view the
mapping (``np.frombuffer`` / ``torch.frombuffer`` on slices), so reading
copies nothing: a leaf's pages are read when it is first used. Leaves come
back as numpy arrays, a bfloat16 leaf as a torch tensor, and a numpy scalar
as a numpy scalar (flax's ``msgpack_restore``).

:func:`dump` and :func:`dumps` write every map with its keys sorted, the
order of fenet's trees after any jitted step (JAX's pytrees sort dict
keys); on such a tree the bytes equal ``flax.serialization.to_bytes``'s.
Leaves may be numpy arrays, numpy scalars, torch tensors (on any device),
str, bool, None, int and float.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's objects end at 2**31 - 1
# bytes; flax leaves a margin.
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
BFLOAT16 = "bfloat16"


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if x <= top:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
            if x >= low:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
    """The header of a str/bin/array/map of length ``n``: a fix form below
    ``fix_max`` (``fix`` None: none), then the first of the 8-, 16- and
    32-bit length forms in ``codes`` (None: no such form) that fits."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of length {n} is too long")


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data


def _pack_bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(n: int, code: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        return bytes((fixext[n], code))
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes((code,))


def _host(leaf) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array leaf, read without a
    copy where its memory is already host and C-contiguous."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            flat = t.reshape(-1).view(torch.int16).numpy()
            return tuple(t.shape), BFLOAT16, memoryview(flat).cast("B")
        leaf = t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    flat = np.ascontiguousarray(arr).reshape(-1)
    return arr.shape, arr.dtype.name, memoryview(flat).cast("B")


def _pack_array(leaf, code: int) -> Iterator[Any]:
    shape, name, data = _host(leaf)
    head = (_sized(len(shape), 0x90, 16, (None, 0xDC, 0xDD))
            + b"".join(_pack_int(int(d)) for d in shape) + _pack_str(name)
            + _pack_bin_header(data.nbytes))
    # The payload: a fixarray of 3 (0x93), then shape, name and bin header.
    yield _ext_header(1 + len(head) + data.nbytes, code)
    yield b"\x93" + head
    yield data


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunked(x) -> dict:
    """flax's ``_chunk``: the flat array in chunks of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x, sort: bool = True) -> Iterator[Any]:
    """The msgpack encoding of ``x`` as a stream of bytes-like pieces."""
    if isinstance(x, dict):
        yield _sized(len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for key in (sorted(x) if sort else x):
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {key!r}")
            yield _pack_str(key)
            yield from _pack(x[key], sort)
    elif _is_array(x):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            # flax writes the chunk map's keys in its own order, unsorted.
            yield from _pack(_chunked(x), sort=False)
        else:
            yield from _pack_array(x, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        yield from _pack_array(np.asarray(x), EXT_NPSCALAR)
    elif x is None:
        yield b"\xc0"
    elif x is True or x is False:
        yield b"\xc3" if x else b"\xc2"
    elif type(x) is int:
        yield _pack_int(x)
    elif type(x) is float:
        yield b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        yield _pack_str(x)
    elif type(x) is bytes:
        yield _pack_bin_header(len(x))
        yield x
    elif type(x) in (list, tuple):
        yield _sized(len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            yield from _pack(item, sort)
    elif isinstance(x, complex):
        raise TypeError("complex leaves (msgpack ExtType 2) are not supported")
    else:
        raise TypeError(f"cannot serialize a leaf of type {type(x).__name__}")


def dumps(tree) -> bytes:
    """The flax msgpack bytes of ``tree`` (maps written with sorted keys)."""
    return b"".join(bytes(piece) for piece in _pack(tree))


def dump(tree, path: str) -> int:
    """Write ``tree`` to ``path`` as :func:`dumps` would, streaming each
    array's memory to the file; returns the bytes written."""
    n = 0
    with open(path, "wb") as f:
        for piece in _pack(tree):
            n += f.write(piece)
    return n


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack stream: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code & 0xF0 == 0x80:
            return self.map(code & 0x0F)
        if code & 0xF0 == 0x90:
            return self.array(code & 0x0F)
        if code & 0xE0 == 0xA0:
            return self.str(code & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in fixed:
            return self.unpack(fixed[code])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= code <= 0xC6:
            return bytes(self.take(self.unpack(lengths[code - 0xC4])))
        if 0xD9 <= code <= 0xDB:
            return self.str(self.unpack(lengths[code - 0xD9]))
        if code in (0xDC, 0xDD):
            return self.array(self.unpack(lengths[code - 0xDB]))
        if code in (0xDE, 0xDF):
            return self.map(self.unpack(lengths[code - 0xDD]))
        if 0xD4 <= code <= 0xD8:
            return self.ext(1 << (code - 0xD4))
        if 0xC7 <= code <= 0xC9:
            return self.ext(self.unpack(lengths[code - 0xC7]))
        raise ValueError(f"msgpack type byte 0x{code:02x} at offset {self.pos - 1} "
                         "is not one flax writes")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out[key] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = _Reader(self.take(n))
        if code == EXT_COMPLEX:
            raise ValueError("complex leaves (msgpack ExtType 2) are not supported")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ExtType {code} is not one flax writes")
        head = payload.unpack(">B")
        if head != 0x93:
            raise ValueError("an array's ExtType payload is not (shape, dtype, bytes)")
        shape = payload.read()
        name = payload.read()
        data = payload.read_bin()
        leaf = _array(data, name, tuple(shape))
        return leaf[()] if code == EXT_NPSCALAR and isinstance(leaf, np.ndarray) else leaf

    def read_bin(self) -> memoryview:
        code = self.unpack(">B")
        if not 0xC4 <= code <= 0xC6:
            raise ValueError(f"an array's data is msgpack type 0x{code:02x}, not bin")
        return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[code]))


def _array(data: memoryview, name, shape: Tuple[int, ...]):
    """A leaf that views ``data``: numpy for numpy's dtypes, torch for
    bfloat16."""
    if name == BFLOAT16:
        if data.nbytes == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    dtype = np.dtype(name)
    if data.nbytes == 0:
        return np.empty(shape, dtype)
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _unchunk(chunked: dict):
    shape = tuple(chunked["shape"][str(i)] for i in range(len(chunked["shape"])))
    chunks = [chunked["chunks"][str(i)] for i in range(len(chunked["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def loads(buffer) -> Any:
    """The tree of a flax msgpack stream. A read-only buffer (``bytes``) is
    copied once into a writable one, so that its leaves are writable."""
    view = memoryview(buffer)
    if view.readonly:
        view = memoryview(bytearray(view))
    return _parse(view.cast("B"))


def _parse(view: memoryview):
    reader = _Reader(view)
    tree = reader.read()
    if reader.pos != len(view):
        raise ValueError(f"{len(view) - reader.pos} bytes after the msgpack object")
    return tree


def load(path: str) -> Any:
    """The tree of a flax ``.ckpt`` file, its leaves viewing a private
    copy-on-write mapping of the file (nothing is copied at load; the
    mapping lives as long as a leaf does)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path} is empty, not a flax checkpoint")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return _parse(memoryview(mapped))
