"""zstd through the system's ``libzstd.so.1``, bound with ``ctypes``.

fenet's orbax checkpoints hold zstd frames (tensorstore's OCDBT nodes and
manifests, and every zarr chunk) whose headers carry no content size, so
they are decoded with the streaming API (``ZSTD_decompressStream``): straight
into a buffer of the known size where there is one (a zarr chunk, which
must fill it exactly), into a growing one where there is not (an OCDBT
node). The library is found by its soname; no header is needed, since the
functions and the ``ZSTD_inBuffer``/``ZSTD_outBuffer`` structs used here
are zstd's stable ABI. Nothing else in the port needs zstd: only a
compressed orbax checkpoint does, and it raises, naming the library, where
the library is missing. :func:`compress` (``ZSTD_compress``) is for tests
and measurements; the port writes no compressed container.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

SONAME = "libzstd.so.1"
# The first output buffer of a decode of unknown size, and its growth.
_FIRST_GUESS = 1 << 16


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(SONAME)
    except OSError as e:
        raise RuntimeError(
            f"decoding zstd needs the system's {SONAME} (Debian/Ubuntu package libzstd1), "
            f"which could not be loaded: {e}. fenet's orbax checkpoints are zstd-compressed; "
            "the port's own .orbax, .ckpt and .pth.tar files need no zstd") from None
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_createDCtx.restype = ptr
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_freeDCtx.argtypes = [ptr]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [ptr, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_compress.argtypes = [ptr, size_t, ptr, size_t, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether ``libzstd.so.1`` loads."""
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def _bytes_of(buf, writable: bool = False) -> np.ndarray:
    """A flat uint8 numpy view of a buffer (bytes, memoryview, mmap slice,
    numpy array or CPU torch tensor), without a copy; it keeps the buffer
    alive while native code uses its address."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("zstd needs a contiguous CPU tensor")
        buf = buf.view(torch.uint8).reshape(-1).numpy() if buf.numel() else np.empty(0, np.uint8)
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    if not arr.flags.c_contiguous:
        raise ValueError("zstd needs a contiguous buffer")
    arr = arr.reshape(-1).view(np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("zstd's output buffer is read-only")
    return arr


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


class _Decoder:
    """One decompression context for one call."""

    def __init__(self, src):
        self.lib = _lib()
        self.src = _bytes_of(src)
        self.inb = _InBuffer(self.src.ctypes.data, self.src.nbytes, 0)
        self.ctx = self.lib.ZSTD_createDCtx()
        if not self.ctx:
            raise MemoryError("ZSTD_createDCtx failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.lib.ZSTD_freeDCtx(self.ctx)

    def step(self, dst: np.ndarray, pos: int) -> tuple:
        """Decode into ``dst`` from ``pos`` until it is full or the input is
        used up: (new pos, zstd's hint, 0 where a frame ended and was
        flushed)."""
        out = _OutBuffer(dst.ctypes.data, dst.nbytes, pos)
        hint = _check(self.lib, self.lib.ZSTD_decompressStream(
            self.ctx, ctypes.byref(out), ctypes.byref(self.inb)), "corrupt frame")
        return out.pos, hint

    def finished(self, hint: int) -> bool:
        return hint == 0 and self.inb.pos == self.inb.size


def decompress_into(src, dst) -> None:
    """Decode the zstd frame(s) in ``src`` into ``dst`` (a writable buffer:
    numpy array, CPU tensor, bytearray), which they must fill exactly."""
    out = _bytes_of(dst, writable=True)
    spill = np.empty(1, np.uint8)
    with _Decoder(src) as dec:
        pos, hint = 0, 1
        while not dec.finished(hint):
            before = (pos, dec.inb.pos)
            if pos < out.nbytes:
                pos, hint = dec.step(out, pos)
            else:  # full: anything more is a size mismatch
                extra, hint = dec.step(spill, 0)
                if extra:
                    raise ValueError(f"zstd: the frame holds more than the {out.nbytes} "
                                     "bytes expected")
            if (pos, dec.inb.pos) == before and hint != 0:
                raise ValueError("zstd: the frame is truncated")
    if pos != out.nbytes:
        raise ValueError(f"zstd: the frame holds {pos} bytes, not the {out.nbytes} expected")


def decompress(src) -> bytearray:
    """The decoded bytes of the zstd frame(s) in ``src``, whose size is not
    known beforehand."""
    out = bytearray(max(_FIRST_GUESS, 4 * len(memoryview(src).cast("B"))))
    with _Decoder(src) as dec:
        pos, hint = 0, 1
        while not dec.finished(hint):
            if pos == len(out):
                out.extend(bytes(len(out)))
            before = (pos, dec.inb.pos)
            pos, hint = dec.step(np.frombuffer(out, np.uint8), pos)
            if (pos, dec.inb.pos) == before and hint != 0:
                raise ValueError("zstd: the frame is truncated")
    del out[pos:]
    return out


def compress(src, level: int) -> bytes:
    """One zstd frame of ``src`` at ``level`` (``ZSTD_compress``)."""
    lib = _lib()
    data = _bytes_of(src)
    out = np.empty(lib.ZSTD_compressBound(data.nbytes), np.uint8)
    n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.nbytes, data.ctypes.data,
                                      data.nbytes, level), "compress")
    return out[:n].tobytes()
