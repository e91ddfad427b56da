"""What every cell shares: finding its files by name, the run's context,
the compared numbers, and the result line.

A cell is its entry in ``BENCHMARK.json`` (its configuration, traffic, chips
and why it exists) and ``workloads/<cell>.json`` (its traffic kind, the
kind's parameters and the limits of its compared numbers); its
configuration is ``configs/<config>.json``, whose ``reference`` key names
its plain reference ``reference/<name>.py`` and its operation count
``counts/<name>.py``, each checked at load against the contract in its
folder's ``__init__.py``; its traffic kind is ``traffic/<kind>.py``, which
exposes ``setup``, ``window``, ``check`` and ``end_to_end``; a per-layer
metric is ``metrics/<metric>.py``, which exposes ``read``. Which metrics a
cell reports is ``BENCHMARK.json``'s: its end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1. ``BENCHMARK.json`` sits beside the
benchmark's folder.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench.counts import CONTRACT as COUNT_CONTRACT
from portbench.reference import CONTRACT as REFERENCE_CONTRACT

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}\Z")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fenet")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def named_file(folder: str, name: str, suffix: str, base: Path = HERE) -> Path:
    """``<base>/<folder>/<name><suffix>``, for a name of the allowed
    characters that has such a file."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name of 1-64 letters, digits, '_', '.', '-'")
    path = base / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}{suffix} for the name {name!r} ({path})")
    return path


_LOADED: Dict[Path, object] = {}


def load_module(path: Path):
    """The module of the file at ``path``, run once a process, as an import
    is: every caller of one file gets the same module."""
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{path.parent.name}_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def load_cell(name: str, base: Path = HERE) -> dict:
    """The cell's entry in ``BENCHMARK.json`` with its workload file."""
    path = named_file("workloads", name, ".json", base)
    entry = next((w for w in benchmark(base.parent)["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name!r} is not a cell of {base.parent / 'BENCHMARK.json'}")
    return {**entry, **load_json(path)}


def load_config(name: str, base: Path = HERE) -> dict:
    """``configs/<name>.json``, refused unless its ``reference`` key names a
    reference and a count that keep their contracts."""
    path = named_file("configs", name, ".json", base)
    config = {"name": name, **load_json(path)}
    if "reference" not in config:
        raise ValueError(f"{path} has no 'reference' key: the name of its "
                         "reference/<name>.py and counts/<name>.py")
    reference_module(config, base)
    count_module(config, base)
    return config


def _kept(folder: str, contract: dict, config: dict, base: Path):
    """``<folder>/<config's reference>.py``, refused unless it exposes every
    function of ``contract`` and each takes the arguments listed there."""
    path = named_file(folder, config["reference"], ".py", base)
    module = load_module(path)
    for fn, (args, keywords) in contract.items():
        try:
            inspect.signature(getattr(module, fn)).bind(*args, **dict.fromkeys(keywords))
        except (AttributeError, TypeError, ValueError) as err:
            raise ValueError(f"{path} breaks the contract of {folder}/: {fn}"
                             f"({', '.join(args + keywords)}): {err}") from None
    return module


def reference_module(config: dict, base: Path = HERE):
    """The plain reference that ``config`` names: ``reference/<name>.py``."""
    return _kept("reference", REFERENCE_CONTRACT, config, base)


def count_module(config: dict, base: Path = HERE):
    """The operation count that ``config`` names: ``counts/<name>.py``."""
    return _kept("counts", COUNT_CONTRACT, config, base)


def traffic(kind: str, base: Path = HERE):
    return load_module(named_file("traffic", kind, ".py", base))


def reader(metric: str, base: Path = HERE):
    return load_module(named_file("metrics", metric, ".py", base))


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moved)]
    return e2e, layer


@dataclass
class Check:
    """A compared number: a gap from the reference, correct while it is at
    most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # False for NaN


@dataclass
class Window:
    """What a traffic kind's window did. ``opened`` is the wall clock
    (``time.time()``) at which it opened; ``seconds`` its length; ``work``
    the samples or requests it completed; ``trace`` the reduced profile of
    a traced window."""

    opened: float
    seconds: float
    work: int
    attempted: int
    failed: int
    trace: Optional[object] = None
    extra: Dict[str, float] = field(default_factory=dict)


@dataclass
class Context:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    peaks: dict
    base: Path = HERE

    @property
    def params(self) -> dict:
        return self.cell["params"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    @property
    def reference(self):
        """The configuration's plain reference module."""
        return reference_module(self.config, self.base)

    @property
    def counts(self):
        """The configuration's operation count module."""
        return count_module(self.config, self.base)

    @property
    def tmp(self) -> str:
        """The run's scratch directory, under TMPDIR."""
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "portbench")
        os.makedirs(path, exist_ok=True)
        return path


def process_start() -> float:
    """The wall clock at which this process started (from /proc; the
    interpreter's start where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time() - time.perf_counter()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, started: float,
             base: Path = HERE):
    """Run one cell once: set-up, the window, the reference's check, the
    metrics. Returns (result line dict, checks)."""
    cell = load_cell(cell_name, base)
    config = load_config(cell["config"], base)
    kind = traffic(cell["kind"], base)
    ctx = Context(cell, config, int(seed), float(seconds), bool(trace), device,
                  load_json(base / "peaks.json"), base)
    state = kind.setup(ctx)
    win = kind.window(ctx, state)
    info = device_info(device, cell["chips"])  # the peak, before the reference runs
    checks = kind.check(ctx, state, win)
    e2e, per_layer = cell_metrics(benchmark(base.parent), cell_name)
    metrics = {}
    if trace:
        for m in per_layer:
            value = reader(m["name"], base).read(ctx, win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=win.trace.busy_s(), window_s=win.trace.window_s)
    else:
        values = dict(kind.end_to_end(ctx, state, win), setup_s=win.opened - started)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    result = {"correct": win.failed == 0 and all(c.ok for c in checks),
              "attempted": win.attempted, "failed": win.failed, "metrics": metrics,
              "device": info}
    if trace:
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks
