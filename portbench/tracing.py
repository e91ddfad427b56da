"""The traced window: ``torch.profiler`` over CPU and CUDA, its Chrome trace
reduced to what the per-layer readers read.

The layers come from spans that the benchmark records around its calls
into each layer of the program (``spans.py``: ``record_function`` ranges,
no Python tracer, whose cost a call doubled the eval step's host time).
Each device operation (kernel, copy, set) is tied to the host call that
launched it by the CUDA correlation id, and takes the layer of every span
that encloses that call on its thread, by the span -> layer map of
``layers.json``. An operation that autograd's engine launched (inside an
``autograd::engine::evaluate_function`` op) belongs to the backward layer.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import torch

HERE = Path(__file__).resolve().parent
WINDOW = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_BACKWARD_OP = "autograd::engine::evaluate_function"


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    layers: frozenset


@dataclass
class Trace:
    """One traced window: its length, its device operations with their
    layers, the benchmark's spans (name, start us, duration us), and the
    device's idle seconds by the innermost span the host was in."""

    window_s: float
    ops: List[DeviceOp]
    spans: List[Tuple[str, float, float]]
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def device_s(self, layer=None, without=None) -> float:
        """Device seconds of the operations in ``layer`` (any if None) and
        not in layer ``without``."""
        return sum(op.dur_us for op in self.ops
                   if (layer is None or layer in op.layers)
                   and (without is None or without not in op.layers)) / 1e6

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return sum(end - start for start, end in _merged(self.ops)) / 1e6

    def idle_percent(self) -> float:
        """The share of the window in which no device operation ran, in %."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def span_s(self, name: str) -> Tuple[float, int]:
        """(seconds, count) of the spans called ``name``."""
        mine = [dur for span, _, dur in self.spans if span == name]
        return sum(mine) / 1e6, len(mine)

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:120]] += op.dur_us / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _merged(ops) -> List[Tuple[float, float]]:
    spans = sorted((op.start_us, op.start_us + op.dur_us) for op in ops)
    out: List[List[float]] = []
    for start, end in spans:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def _enclosing(events, points):
    """For each key -> (thread, time) of ``points`` the names of the events
    of ``events`` (thread -> [(start, end, name)]) that enclose it,
    outermost first. Events of one thread nest, as calls do."""
    out = {}
    by_thread = defaultdict(list)
    for key, (tid, ts) in points.items():
        by_thread[tid].append((ts, key))
    for tid, queries in by_thread.items():
        spans = sorted(events.get(tid, []))
        queries.sort()
        stack: List[Tuple[float, float, str]] = []
        i = 0
        for ts, key in queries:
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[key] = [name for _, end, name in stack if end >= ts]
    return out


def reduce_trace(path: str, window_s: float) -> Trace:
    """The Chrome trace at ``path`` -> :class:`Trace`, clipped to the
    ``portbench.window`` span."""
    rules = json.loads((HERE / "layers.json").read_text())
    events = json.loads(Path(path).read_text())["traceEvents"]
    launches, device, spans, backward = {}, [], defaultdict(list), defaultdict(list)
    lo, hi, main = float("-inf"), float("inf"), None
    for e in events:
        cat = e.get("cat")
        if cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat in _DEVICE_CATS:
            device.append(e)
        elif cat == "user_annotation":
            spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if e["name"] == WINDOW:
                lo, hi, main = e["ts"], e["ts"] + e["dur"], e["tid"]
        elif cat == "cpu_op" and e["name"].startswith(_BACKWARD_OP):
            backward[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    device = [e for e in device if lo <= e["ts"] <= hi]
    points = {i: launches[e["args"]["correlation"]] for i, e in enumerate(device)
              if e["args"].get("correlation") in launches}
    around = _enclosing(spans, points)
    in_backward = _enclosing(backward, points)
    ops = []
    for i, e in enumerate(device):
        if in_backward.get(i):
            layers = {rules["backward"]}
        else:
            layers = {layer for name in around.get(i, []) for prefix, layer in rules["spans"]
                      if name.startswith(prefix)}
        ops.append(DeviceOp(e["name"], e["ts"], e["dur"], frozenset(layers)))
    own = [(name, s, end - s) for tid in spans for s, end, name in spans[tid]
           if name.startswith("portbench.") and name != WINDOW]
    trace = Trace(window_s, ops, own)
    trace.idle_by_host = _idle_by_host(ops, spans, main, lo, hi)
    return trace


def _idle_by_host(ops, spans, main, lo, hi) -> Dict[str, float]:
    """Idle device seconds by the innermost span on the benchmark's thread
    at the middle of each gap ("host" outside every span but the
    window's)."""
    busy = _merged(ops)
    if not busy or main is None:
        return {}
    edges = [(lo, busy[0][0])] + [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    edges = [(a, b) for a, b in edges + [(busy[-1][1], hi)] if b > a]
    names = _enclosing(spans, {k: (main, (a + b) / 2) for k, (a, b) in enumerate(edges)})
    out: Dict[str, float] = defaultdict(float)
    for k, (a, b) in enumerate(edges):
        inner = [n for n in names.get(k, []) if n != WINDOW]
        out[inner[-1] if inner else "host"] += (b - a) / 1e6
    return dict(out)


@contextlib.contextmanager
def traced(out_dir: str, device: torch.device):
    """Profile the block as one window; yields a dict whose ``trace`` is
    the reduced :class:`Trace` after the block. The Chrome trace is written
    to ``out_dir`` and deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    holder: dict = {}
    sync(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            yield holder
            sync(device)
            window_s = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        holder["trace"] = reduce_trace(path, window_s)
    finally:
        os.remove(path)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
