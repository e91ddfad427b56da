"""Profiling and timing (counterpart of ``fenet/utils/profiling.py``).

The reference times with wall-clock AverageMeters only (train.py:137-138,
201-203). This holds a ``torch.profiler`` trace viewable in Perfetto or
chrome://tracing; ``span``, the named ranges the program records on that
trace's timeline, and ``recording``, which tells the program's counts
whether to count; and a timer that waits for the devices each call, since a
CUDA launch returns before its work is done and a bare host clock times the
enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


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


def recording() -> bool:
    """Whether a profiler records: the program's spans and counts are on
    only then."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A named range of the program on the profiler's timeline:
    ``with span("fenet_torch.train.loss"): ...``. While a profiler records,
    a ``torch.profiler.record_function`` range, on the calling thread and
    the same clock as the device's kernels, so that each launch inside it
    can be tied to it; otherwise a context that does nothing, at the cost
    of one flag read."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
