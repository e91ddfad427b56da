"""Batching with a background prefetch thread (counterpart of
``fenet/data/loader.py``). Batches are dicts of numpy arrays; the eval step
moves them to the device.

A dataset with a ``load_batch(indices)`` method serves a whole batch at
once (ShapeNetDataset's native path); where it declines (returns None),
the batch is collated from ``__getitem__``. ``batch_counts`` counts both,
so that a fallback cannot pass unseen.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

# Batches served by a dataset's load_batch ("native") and batches it
# declined, collated item by item instead ("declined"), in this process.
batch_counts = {"native": 0, "declined": 0}
_counts_lock = threading.Lock()


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack(vals)
        else:
            out[key] = vals  # e.g. string names
    return out


class DataLoader:
    """Epoch iterator: shuffle / batch / drop_last / prefetch.

    Args:
      dataset: len() + __getitem__ -> dict of numpy arrays, and optionally
        load_batch(indices) -> the batch dict, or None to decline.
      batch_size, shuffle, drop_last: as in torch.
      prefetch: queue depth of pre-assembled batches (0 disables the thread).
      seed: shuffle seed.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(len(self)):
            yield order[i * self.batch_size : (i + 1) * self.batch_size]

    def _make_batch(self, idxs) -> Dict[str, np.ndarray]:
        load_batch = getattr(self.dataset, "load_batch", None)
        if load_batch is not None:
            batch = load_batch([int(i) for i in idxs])
            with _counts_lock:
                batch_counts["native" if batch is not None else "declined"] += 1
            if batch is not None:
                return batch
        return _collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            for idxs in self._batch_indices():
                yield self._make_batch(idxs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for idxs in self._batch_indices():
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idxs))
            except Exception as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
