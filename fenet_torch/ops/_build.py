"""Build the CUDA kernels in ``fenet_torch/csrc`` at first use.

Each ``.cu`` file is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch header is involved,
so a build takes seconds. Libraries go to ``build/fenet_torch/`` at the root
of the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. All missing
libraries are compiled in parallel, one ``nvcc`` process per source.

The wrappers check their tensors here before a pointer crosses into C, and
raise on a launch that returned a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fenet_torch"

# Kernel library name -> source file in csrc/.
SOURCES = {
    "chamfer_nn": "chamfer_nn.cu",
    "emd_auction": "emd_auction.cu",
    "sinkhorn": "sinkhorn.cu",
    "sinkhorn_plan": "sinkhorn_plan.cu",
    "adam": "adam.cu",
    "se_gate": "se_gate.cu",
}

# No --use_fast_math: the chamfer and auction kernels' arithmetic must be
# IEEE float32 to agree with their plain PyTorch versions bit for bit. The
# Sinkhorn kernel, held to fenet's tolerance rather than to bit-exactness,
# asks for its one approximate instruction (ex2.approx) itself, by intrinsic;
# the plan kernel takes the accurate expf, as torch.exp does.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# The types of every C entry point (``extern "C" int fenet_*`` in csrc/),
# set once, when its library is loaded, and never on a call: {library:
# {symbol: (argtypes, restype)}}. Pointers and the stream are c_void_p (a
# plain int would cut them to 32 bits).
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_AUCTION_TAIL = [_INT] * 2 + [_PTR] + [_INT] * 4 + [_FLOAT, _PTR]
SIGNATURES = {
    "chamfer_nn": {"fenet_chamfer_nn_split": ([_PTR] * 5 + [_INT] * 4 + [_PTR], _INT)},
    "emd_auction": {
        "fenet_emd_auction": ([_PTR] * 5 + _AUCTION_TAIL, _INT),
        "fenet_emd_auction_stream": ([_PTR] * 6 + _AUCTION_TAIL, _INT),
        "fenet_emd_root_check": ([_PTR, _PTR], _INT),
    },
    "sinkhorn": {"fenet_sinkhorn": ([_PTR] * 5 + [_INT] * 4 + [_FLOAT] * 2 + [_PTR], _INT)},
    "sinkhorn_plan": {
        "fenet_sinkhorn_plan_rows": ([_PTR] * 6 + [_INT] * 3 + [_FLOAT] * 3 + [_PTR], _INT),
        "fenet_sinkhorn_plan_cols": ([_PTR] * 6 + [_INT] * 3 + [_FLOAT] * 3 + [_PTR], _INT),
    },
    "adam": {"fenet_adam": ([_PTR] * 4 + [_INT] + [_FLOAT] * 5 + [_PTR], _INT)},
    "se_gate": {
        "fenet_se_squeeze": ([_PTR] * 3 + [_INT] * 2 + [_PTR], _INT),
        "fenet_se_excite_backward": ([_PTR] * 8 + [_INT] * 4 + [_PTR], _INT),
        "fenet_se_scale": ([_PTR] * 4 + [_INT] * 4 + [_PTR] * 9, _INT),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named library that is not built yet, all at once.

    Returns ``{name: ptxas report}`` for the libraries compiled by this call
    (registers, shared memory and spills per kernel). Raises RuntimeError
    with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (target, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the types of ``lib``'s functions listed in SIGNATURES[name]; a
    function the library lacks (an earlier source, built by a development
    tool) is skipped. ctypes keeps each function object on the library, so
    the types stay set."""
    for symbol, (argtypes, restype) in SIGNATURES.get(name, {}).items():
        fn = getattr(lib, symbol, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = bind(name, ctypes.CDLL(str(_target(name))))
    return lib


def check_clouds(a, b, kernel: str) -> None:
    """Raise ValueError unless a (B,N,3) and b (B,M,3) are what a kernel
    takes: float32, contiguous, N and M > 0, on one CUDA device."""
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {x.device}, not a CUDA device")
        if x.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} has dtype {x.dtype}, needs float32")
        if x.dim() != 3 or x.shape[-1] != 3 or x.shape[1] == 0:
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, needs (B, N>0, 3)")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if a.device != b.device or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"{kernel}: clouds on {a.device}/{b.device} with batch "
            f"{a.shape[0]}/{b.shape[0]} do not pair up")


def check(status: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
