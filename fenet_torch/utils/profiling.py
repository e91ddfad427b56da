"""Profiling and timing (counterpart of ``fenet/utils/profiling.py``).

The reference times with wall-clock AverageMeters only (train.py:137-138,
201-203). This adds a ``torch.profiler`` trace viewable in Perfetto or
chrome://tracing, and a timer that waits for the devices each call, since a
CUDA launch returns before its work is done and a bare host clock times the
enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write a Chrome trace,
    ``{log_dir}/trace_{pid}_{ns}.json``: ``with trace('/tmp/t'): step()``.
    The host's operators always, the card's kernels where CUDA is there;
    yields the profiler (``key_averages()`` and the like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _devices(x, found: set) -> set:
    """The CUDA devices of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, found)
    return found


def _sync(out) -> None:
    for device in _devices(out, set()):
        torch.cuda.synchronize(device)


def synced_seconds(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Wall-clock seconds a call of ``fn(*args)``, the devices of its
    outputs synchronised after every call (fenet forces a fetch there);
    ``warmup`` calls first, untimed."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.time()
    for _ in range(iters):
        _sync(fn(*args))
    return (time.time() - t0) / iters


class StepTimer:
    """Rolling per-phase timings: ``timer.tick('data'); ...; timer.tick('step')``."""

    def __init__(self):
        self._last = time.time()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def tick(self, phase: str) -> float:
        now = time.time()
        dt = now - self._last
        self._last = now
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + 1
        return dt

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}
