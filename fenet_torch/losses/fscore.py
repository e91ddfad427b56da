"""F-score between point clouds (counterpart of ``fenet/losses/fscore.py``;
the reference's loss/loss_.py:122-140)."""

from __future__ import annotations

import torch

from fenet_torch.ops.chamfer import chamfer_distance


def fscore(x: torch.Tensor, y: torch.Tensor, threshold: float = 1e-4):
    """F-score at a squared-distance threshold (default 1e-4).

    ``x`` (B, N, 3), ``y`` (B, M, 3). Returns (fscore, precision_1,
    precision_2), scalar tensors: the batch means of each element's
    F-score and of its two fractions of points whose nearest neighbour in
    the other cloud lies within the threshold. An element with no point
    within it on either side (F-score 0/0, NaN) counts as 0, as the
    reference's ``fscore[isnan] = 0``. On a card the two nearest-neighbour
    passes are the chamfer kernel's two launches.
    """
    dist1, dist2, _, _ = chamfer_distance(x, y)
    p1 = (dist1 < threshold).float().mean(dim=1)
    p2 = (dist2 < threshold).float().mean(dim=1)
    f = 2 * p1 * p2 / (p1 + p2)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return f.mean(), p1.mean(), p2.mean()
