"""Micro-batching: many concurrent single-image requests -> one padded batch
(counterpart of ``fenet/serve/batcher.py``, with the same API).

Requests enqueue an (image, Future) pair. One dispatcher thread drains up to
``max_batch`` of them every ``window_ms`` (sooner when a full batch is
waiting), pads to ``max_batch`` so the forward always sees one shape, runs
the forward and fans the rows back out through the futures. One thread keeps
one batch in flight on the device in submission order; the queue is the
only hand-off.

The pipeline is one deep: batch i is fetched only after batch i+1 has been
dispatched, so i+1's host work and upload overlap i's compute. On CUDA that
holds only if the forward neither blocks on its upload (pinned memory,
``non_blocking``) nor on its compute; :func:`fenet_torch.serve.server.
device_forward` builds such a forward.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch


def fetch(out) -> np.ndarray:
    """The host's float32 copy of a forward's result: a tensor on any device
    (this waits for the device), a list of such shards (a forward over
    several devices; concatenated in order), or anything ``np.asarray``
    takes."""
    if isinstance(out, torch.Tensor):
        return out.float().cpu().numpy()
    if isinstance(out, list):
        return np.concatenate([fetch(part) for part in out])
    return np.asarray(out, np.float32)


class MicroBatcher:
    """Batch single-image requests into fixed-size forward calls.

    ``forward`` takes a (max_batch, H, W, C) uint8 array and returns the
    (max_batch, num_points, 3) clouds, row i for input row i: a tensor still
    being computed on the device, or an array-like. The result is fetched
    when the batch resolves.
    """

    def __init__(self, forward: Callable[[np.ndarray], object],
                 max_batch: int = 32, window_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._forward = forward
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()  # makes submit/close atomic
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, C) uint8 image; resolves to (num_points, 3)
        float32. Raises after close()."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put((np.asarray(image), fut))
        return fut

    def predict(self, image: np.ndarray) -> np.ndarray:
        return self.submit(image).result()

    def close(self, timeout: float = 10.0):
        """Stop the dispatcher; queued requests still drain first."""
        with self._submit_lock:  # no submit can slip in past the sentinel
            self._closed.set()
            self._queue.put(None)  # wake the blocking get
        self._thread.join(timeout)

    # -- dispatcher -------------------------------------------------------
    def _collect(self, block: bool) -> Sequence:
        """Up to max_batch requests within the window, fewer if the window
        ends first. ``block=False`` (a batch is in flight) returns [] at
        once when the queue is idle, so the caller resolves that batch."""
        try:
            if not block:
                first = self._queue.get_nowait()
            elif self._closed.is_set():
                # Bounded, so the drain loop sees the queue empty: the wake
                # sentinel is consumed on first receipt.
                first = self._queue.get(timeout=0.05)
            else:
                first = self._queue.get()
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _resolve(self, batch, out):
        """Fetch a dispatched batch's clouds and fan the rows out. A device
        error surfaces here: it fails this batch's futures only."""
        try:
            clouds = fetch(out)
        except Exception as e:
            for _, fut in batch:
                fut.set_exception(e)
            return
        for row, (_, fut) in enumerate(batch):
            fut.set_result(clouds[row])

    def _loop(self):
        pending = None  # (batch, in-flight result)
        while True:
            batch = self._collect(block=pending is None)
            if not batch:
                if pending is not None:
                    self._resolve(*pending)
                    pending = None
                    continue
                if self._closed.is_set() and self._queue.empty():
                    return
                continue
            try:
                # Assembly is inside the try: images of mixed sizes fail
                # their batch, not the dispatcher.
                images = np.stack([img for img, _ in batch])
                n = images.shape[0]
                if n < self._max_batch:  # one shape: pad to the fixed batch
                    images = np.concatenate(
                        [images, images[-1:].repeat(self._max_batch - n, 0)])
                out = self._forward(images)
            except Exception as e:  # fail this batch, keep serving
                for _, fut in batch:
                    fut.set_exception(e)
                if pending is not None:  # do not strand a computed batch
                    self._resolve(*pending)
                    pending = None
                continue
            if pending is not None:
                self._resolve(*pending)
            pending = (batch, out)
