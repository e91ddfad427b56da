"""zarr v2 arrays as orbax keeps them: ``<name>/.zarray`` (JSON) and
chunk keys ``<name>/<i>.<j>...`` (``0`` for a 0-d array), read from a key
source, which is an OCDBT store (:class:`fenet_torch.train.ocdbt.Store`) or
a plain directory (:class:`Directory`), and written to a directory.

Read: dtypes little-endian or byte-sized numpy kinds b, i, u, f (``<f4``,
``<f8``, ``<i4``, ``<i8``, ``|u1``, ``|b1``, ...) as numpy arrays, and
tensorstore's ``bfloat16`` as a ``torch.bfloat16`` tensor (numpy has no
bfloat16); order ``C`` (``F`` raises); compressor ``zstd``
(:mod:`fenet_torch.native.zstd`) or null, any other raising; no filters;
``dimension_separator`` ``.`` or ``/``; any chunk grid, edge chunks
included; a missing chunk reads as ``fill_value`` (null: zeros). An
uncompressed chunk that is the whole array is returned as a view of its
source (a directory's file is mapped copy-on-write); any other is decoded
or copied into the array.

Write: one uncompressed chunk per array, ``compressor`` null, order C,
``fill_value`` null.
"""

from __future__ import annotations

import itertools
import json
import math
import mmap
import os

import numpy as np
import torch

ZARRAY = ".zarray"
BFLOAT16 = "bfloat16"


class Directory:
    """Keys as files under ``root`` (``a/b`` is ``root/a/b``). A read is one
    ``open`` and no ``stat``: where each is a round trip to the file system
    (a 9p mount), an A2 training state's 1,430 files cost that many."""

    def __init__(self, root: str):
        self.root = str(root)

    def read(self, key: str) -> memoryview:
        """A private copy-on-write mapping of the key's file (KeyError where
        there is none)."""
        try:
            f = open(os.path.join(self.root, key), "rb")
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            raise KeyError(key) from None
        with f:
            if os.fstat(f.fileno()).st_size == 0:
                return memoryview(bytearray())
            return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY))


def _dtype(spec):
    """(numpy dtype or torch.bfloat16, itemsize) of a ``.zarray`` dtype."""
    if spec == BFLOAT16:
        return torch.bfloat16, 2
    if not isinstance(spec, str):
        raise ValueError(f"zarr dtype {spec!r}: structured dtypes are not read")
    dtype = np.dtype(spec)
    if dtype.kind not in "biuf" or dtype.byteorder not in "<|=":
        raise ValueError(f"zarr dtype {spec!r} is not a little-endian bool, int, uint or float")
    return dtype, dtype.itemsize


def _view(buf, dtype, shape):
    """``buf``'s bytes as an array of ``dtype`` and ``shape``."""
    if dtype is torch.bfloat16:
        if len(buf) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _fill(out: np.ndarray, dtype, value) -> None:
    """Fill ``out`` (uint8 bytes) with ``fill_value`` (JSON: a number,
    ``"NaN"``, ``"Infinity"``, ``"-Infinity"``, or null for zeros)."""
    if value is None:
        out[:] = 0
        return
    value = float(value) if isinstance(value, str) else value
    if dtype is torch.bfloat16:
        one = torch.tensor([value], dtype=torch.bfloat16).view(torch.uint8).numpy()
    else:
        one = np.asarray([value], dtype).view(np.uint8)
    out.reshape(-1, one.size)[:] = one


def read_array(source, name: str):
    """The array ``name`` of ``source``: numpy, or torch for bfloat16."""
    meta = json.loads(bytes(source.read(f"{name}/{ZARRAY}")))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')!r} is not 2")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r} is not read (only C)")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {compressor.get('id')!r} is not read "
                         "(only zstd and null)")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{name}: zarr dimension_separator {sep!r} is neither '.' nor '/'")
    dtype, itemsize = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    chunk_bytes = math.prod(chunks) * itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]

    def key(index) -> str:
        return f"{name}/{sep.join(map(str, index)) if index else '0'}"

    def chunk(index, into: np.ndarray) -> bool:
        """Decode chunk ``index`` into ``into``; False where it is missing."""
        try:
            data = source.read(key(index))
        except KeyError:
            return False
        if compressor is None:
            if len(data) != chunk_bytes:
                raise ValueError(f"{key(index)}: {len(data)} bytes, not {chunk_bytes}")
            into[:] = np.frombuffer(data, np.uint8)
        else:
            from fenet_torch.native import zstd

            zstd.decompress_into(data, into)
        return True

    first = (0,) * len(shape)
    if chunks == shape and compressor is None:
        try:
            data = source.read(key(first))
        except KeyError:
            data = None
        if data is not None and not data.readonly and len(data) == chunk_bytes:
            return _view(data, dtype, shape)  # a view, not a copy
    out = np.empty(math.prod(shape) * itemsize, np.uint8)
    if chunks == shape:
        if not chunk(first, out):
            _fill(out, dtype, meta.get("fill_value"))
        return _view(out, dtype, shape)
    # Several chunks: each decoded whole, its part inside the array copied.
    full = out.reshape(*shape, itemsize)
    buf = np.empty(chunk_bytes, np.uint8)
    for index in itertools.product(*grid):
        if not chunk(index, buf):
            _fill(buf, dtype, meta.get("fill_value"))
        src = buf.reshape(*chunks, itemsize)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        full[region] = src[tuple(slice(0, r.stop - r.start) for r in region)]
    return _view(out, dtype, shape)


def _host_bytes(leaf):
    """(zarr dtype, shape, C-order bytes) of an array leaf, without a copy
    where it is already host memory in C order."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BFLOAT16, tuple(t.shape), t.view(torch.int16).numpy()
        leaf = t.numpy()
    arr = np.require(np.asarray(leaf), requirements="C")
    if arr.dtype.kind not in "biuf":
        raise ValueError(f"cannot write a zarr array of dtype {arr.dtype}")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return arr.dtype.str, arr.shape, arr


def write_array(root: str, name: str, leaf) -> int:
    """Write ``leaf`` as the zarr array ``root/name``: its ``.zarray`` and
    one uncompressed chunk. Returns the chunk's bytes."""
    spec, shape, arr = _host_bytes(leaf)
    os.makedirs(os.path.join(root, name))
    meta = {"chunks": [max(1, d) for d in shape], "compressor": None,
            "dimension_separator": ".", "dtype": spec, "fill_value": None, "filters": None,
            "order": "C", "shape": list(shape), "zarr_format": 2}
    with open(os.path.join(root, name, ZARRAY), "w") as f:
        json.dump(meta, f)
    if arr.size == 0:
        return 0
    with open(os.path.join(root, name, ".".join("0" * len(shape)) or "0"), "wb") as f:
        return f.write(memoryview(arr.reshape(-1)).cast("B"))

