"""Eval metrics with best-checkpoint comparison semantics (counterpart of
``fenet/eval/metrics.py``): EMD at eps 0.005 and 50 iterations, sqrt-mean
x100; Chamfer mean+mean x100; lower is better, initial value 32767.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from fenet_torch.ops.chamfer import chamfer_distance
from fenet_torch.ops.emd import earth_mover_distance

EVAL_EMD_EPS = 0.005
EVAL_EMD_ITERS = 50


@torch.inference_mode()
def eval_metrics(pred: torch.Tensor, gt: torch.Tensor,
                 emd_eps: float = EVAL_EMD_EPS,
                 emd_iters: int = EVAL_EMD_ITERS) -> Dict[str, torch.Tensor]:
    """Batch-mean EMD and Chamfer metrics, both x100."""
    emd_sq, _ = earth_mover_distance(pred, gt, emd_eps, emd_iters)
    d1, d2, _, _ = chamfer_distance(pred, gt)
    return {
        "EMD_distance": torch.sqrt(emd_sq).mean() * 100.0,
        "ChamferDistance": (d1.mean() + d2.mean()) * 100.0,
    }


class Metrics:
    """Value object over the metric registry."""

    ITEMS = [
        {"name": "EMD_distance", "enabled": True,
         "is_greater_better": False, "init_value": 32767},
        {"name": "ChamferDistance", "enabled": True,
         "is_greater_better": False, "init_value": 32767},
    ]

    @classmethod
    def items(cls) -> List[dict]:
        return [i for i in cls.ITEMS if i["enabled"]]

    @classmethod
    def names(cls) -> List[str]:
        return [i["name"] for i in cls.items()]

    @classmethod
    def get(cls, pred: torch.Tensor, gt: torch.Tensor) -> List[float]:
        vals = eval_metrics(pred, gt)
        return [float(vals[n]) for n in cls.names()]

    def __init__(self, metric_name: str, values):
        self._items = Metrics.items()
        self._values = [item["init_value"] for item in self._items]
        self.metric_name = metric_name
        if isinstance(values, list):
            self._values = list(values)
        elif isinstance(values, dict):
            index = {item["name"]: i for i, item in enumerate(self._items)}
            for k, v in values.items():
                if k in index:
                    self._values[index[k]] = v
        else:
            raise TypeError(f"Unsupported value type: {type(values)}")

    def state_dict(self) -> Dict[str, float]:
        return {item["name"]: value for item, value in zip(self._items, self._values)}

    def __repr__(self):
        return str(self.state_dict())

    def better_than(self, other: "Metrics | None") -> bool:
        if other is None:
            return True
        idx = next(i for i, item in enumerate(self._items)
                   if item["name"] == self.metric_name)
        if self._items[idx]["is_greater_better"]:
            return self._values[idx] > other._values[idx]
        return self._values[idx] < other._values[idx]
