"""What the kernel development tools share: build variants of one kernel
source, time a call with CUDA events, sample the card's SM clock and power.

A tool builds each ``{label: source}`` with the flags of
``fenet_torch.ops._build``, one ``nvcc`` each, all at once, into
``build/<tool>/``, and swaps the loaded library into ``_build._loaded`` to
run a variant through the package's own wrapper.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from fenet_torch.ops import _build

ROOT = _build._PKG.parent


class Emitter:
    """Print one JSON line and append it to a log under ``chiprun_out/``."""

    def __init__(self, log_name: str):
        self.log = ROOT / "chiprun_out" / log_name
        self.log.parent.mkdir(exist_ok=True)

    def __call__(self, obj, echo: bool = True) -> None:
        line = json.dumps(obj)
        if echo:
            print(line, flush=True)
        with self.log.open("a") as fh:
            fh.write(line + "\n")


def build(libs, name: str, emit):
    """{label: source} of the kernel library ``name`` -> ({label:
    ctypes.CDLL}, [labels that failed]), all nvcc at once; emits each
    build's ptxas lines."""
    out_dir = ROOT / "build" / f"{name}_dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in libs.items():
        target = out_dir / f"lib{name}-{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(src)]
        procs[label] = (target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    loaded, failed = {}, []
    for label, (target, proc) in procs.items():
        out, _ = proc.communicate()
        emit({"build": label, "rc": proc.returncode, "ptxas": [
            ln.strip() for ln in out.splitlines()
            if "Used" in ln or "spill" in ln or "error" in ln or "warning" in ln]})
        if proc.returncode == 0:
            loaded[label] = _build.bind(name, ctypes.CDLL(str(target)))
        else:
            failed.append(label)
            print(out, file=sys.stderr)
    return loaded, failed


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``reps`` calls by CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``reps`` replays
    of a CUDA graph that holds ``launches`` calls, so that the host's cost
    of a call (argument checks, allocation, the ctypes call) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def sampler():
    """nvidia-smi printing the SM clock and power draw every 100 ms."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def clocks(proc):
    """Stop an nvidia-smi sampler; (median SM MHz, median W) or None."""
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
    try:
        mhz = sorted(float(a) for a, _ in rows)
        watts = sorted(float(b) for _, b in rows)
    except ValueError:
        return None
    return (mhz[len(mhz) // 2], watts[len(watts) // 2]) if rows else None


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def sources(specs, name: str):
    """``--source LABEL=PATH`` arguments, then the package's own source of
    library ``name`` as ``new``: {label: path}."""
    libs = {}
    for spec in specs:
        label, path = spec.split("=", 1)
        libs[label] = Path(path)
    libs["new"] = _build.CSRC / _build.SOURCES[name]
    return libs
