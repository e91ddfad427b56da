"""Multi-item running average meter (counterpart of
``fenet/utils/average_meter.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union


class AverageMeter:
    """Tracks val/sum/count, either for one scalar or a named list of items.

    ``val()``/``avg()`` return the full list (or scalar), or one item when
    given an index, the reference's interface.
    """

    def __init__(self, items: Optional[Sequence[str]] = None):
        self.items = list(items) if items is not None else None
        self.n_items = 1 if items is None else len(items)
        self.reset()

    def reset(self):
        self._val = [0.0] * self.n_items
        self._sum = [0.0] * self.n_items
        self._count = [0] * self.n_items

    def update(self, values: Union[float, Sequence[float]]):
        if isinstance(values, (list, tuple)):
            for i, v in enumerate(values):
                self._val[i] = float(v)
                self._sum[i] += float(v)
                self._count[i] += 1
        else:
            self._val[0] = float(values)
            self._sum[0] += float(values)
            self._count[0] += 1

    def val(self, idx: Optional[int] = None):
        if self.items is None:
            return self._val[0] if idx is None else self._val[idx]
        return self._val if idx is None else self._val[idx]

    def count(self, idx: Optional[int] = None):
        if self.items is None:
            return self._count[0] if idx is None else self._count[idx]
        return self._count if idx is None else self._count[idx]

    def avg(self, idx: Optional[int] = None) -> Union[float, List[float]]:
        def one(i):
            return self._sum[i] / self._count[i] if self._count[i] else 0.0

        if self.items is None:
            return one(0) if idx is None else one(idx)
        if idx is None:
            return [one(i) for i in range(self.n_items)]
        return one(idx)
