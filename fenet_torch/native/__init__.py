"""Native (C++) host data path: a whole batch of renders decoded and cropped,
and of ``.npy`` clouds read, by a pool of threads (counterpart of
``fenet/native/__init__.py``).

``loader.cpp`` is compiled with g++ at first use into ``build/fenet_torch/``
at the root of the checkout, named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. It needs
g++ and zlib (its PNG decoder is its own, so no libpng). A failed build is
kept: its error, with the compiler's output, is logged once and returned by
:func:`build_error`, and the library is not built again in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fenet_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz", "-pthread"]
VERSION = 1
# fenet's thread count for a batch.
N_THREADS = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libfenet_torch_loader-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile to a file of this process and thread, then move it into
    place: several processes may build at once."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), *LIBS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built or loaded (see :func:`build_error`)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            paths, ptr, c_int = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int
            lib.fenet_torch_load_images.argtypes = [paths, c_int, ptr, c_int, c_int]
            lib.fenet_torch_load_images.restype = c_int
            lib.fenet_torch_load_clouds.argtypes = [paths, c_int, c_int, ptr, c_int]
            lib.fenet_torch_load_clouds.restype = c_int
            lib.fenet_torch_loader_version.restype = c_int
            if lib.fenet_torch_loader_version() != VERSION:
                raise RuntimeError(f"{target} is not version {VERSION}")
        except (OSError, RuntimeError) as e:  # no g++, a failed compile or load
            _error = f"native loader unavailable: {e}"
            logging.getLogger(__name__).error(_error)
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return _error


def _pack_paths(paths: List[str]) -> bytes:
    return b"".join(os.fsencode(p) + b"\0" for p in paths)


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(_error)
    return lib


def load_images(paths: List[str], n_threads: int = N_THREADS,
                dtype=np.float32) -> np.ndarray:
    """Decode a batch of 137x137 ShapeNet renders -> (N, 128, 128, 3) RGB,
    the [4:-5, 4:-5] crop, raw 0..255, as float32 or uint8. Raises IOError
    if any image cannot be read or is not 137x137."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.uint8):
        raise ValueError(f"dtype must be float32 or uint8, got {dtype}")
    lib = _require_lib()
    out = np.empty((len(paths), 128, 128, 3), dtype)
    failures = lib.fenet_torch_load_images(_pack_paths(paths), len(paths), out.ctypes.data,
                                           int(dtype == np.uint8), n_threads)
    if failures:
        raise IOError(f"native loader: {failures} image(s) failed to decode")
    return out


def load_clouds(paths: List[str], points: int, n_threads: int = N_THREADS) -> np.ndarray:
    """Load a batch of (points, 3) <f4/<f8 .npy clouds -> (N, points, 3)
    float32. Raises IOError if any file cannot be read or has another
    shape or type."""
    lib = _require_lib()
    out = np.empty((len(paths), points, 3), np.float32)
    failures = lib.fenet_torch_load_clouds(_pack_paths(paths), len(paths), points,
                                           out.ctypes.data, n_threads)
    if failures:
        raise IOError(f"native loader: {failures} cloud(s) failed to load")
    return out
