"""Training-loss facade with the reference's semantics (counterpart of
``fenet/losses/facade.py``): chamfer and auction EMD losses, the
reference's PointLoss helpers and the epoch-scheduled total.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fenet_torch.ops.chamfer import chamfer_distance
from fenet_torch.ops.emd import earth_mover_distance

# Reference operator settings: train-time EMD vs eval-time.
TRAIN_EMD_EPS = 0.05
TRAIN_EMD_ITERS = 3000
EVAL_EMD_EPS = 0.005
EVAL_EMD_ITERS = 50


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """mean(dist1) + mean(dist2) of squared NN distances."""
    dist1, dist2, _, _ = chamfer_distance(pred, gt)
    return dist1.mean() + dist2.mean()


def emd_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    eps: float = TRAIN_EMD_EPS,
    iters: int = TRAIN_EMD_ITERS,
    scale_phases: int = 1,
    early_exit: bool = True,
    scale_thresh: float = 0.0,
) -> torch.Tensor:
    """sqrt of matched squared distances, averaged over points, then batch."""
    dist, _ = earth_mover_distance(pred, gt, eps, iters, scale_phases, early_exit,
                                   scale_thresh)
    return torch.sqrt(dist).mean(dim=1).mean()


def point_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The reference's PointLoss: (0.5·mean(dist1) + 0.5·mean(dist2))·100."""
    dist1, dist2, _, _ = chamfer_distance(pred, gt)
    return (0.5 * dist1.mean() + 0.5 * dist2.mean()) * 100.0


def point_loss_test(pred: torch.Tensor, gt: torch.Tensor):
    """The reference's PointLoss_test: (d1 + d2, d1, d2) of the means."""
    dist1, dist2, _, _ = chamfer_distance(pred, gt)
    d1, d2 = dist1.mean(), dist2.mean()
    return d1 + d2, d1, d2


class Loss:
    """Object facade mirroring the reference's class Loss."""

    def __init__(self, radius: float = 1.0):
        self.radius = radius

    @staticmethod
    def get_chamfer_loss(pred, gt):
        return chamfer_loss(pred, gt)

    @staticmethod
    def get_emd_loss(pred, gt, radius: float = 1.0):
        return emd_loss(pred, gt)


def scheduled_total_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    epoch: int,
    lambda_cd: float = 100.0,
    lambda_emd: float = 100.0,
    emd_eps: float = TRAIN_EMD_EPS,
    emd_iters: int = TRAIN_EMD_ITERS,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's epoch-scheduled loss:

    epochs 1-30:  lambda_cd·CD + lambda_emd·EMD
    epochs 31-50: lambda_emd·EMD (CD still computed, for the log)
    """
    cd = chamfer_loss(pred, gt)
    emd = emd_loss(pred, gt, emd_eps, emd_iters)
    total = lambda_emd * emd if epoch > 30 else lambda_cd * cd + lambda_emd * emd
    return total, {"chamfer_loss": cd, "emd_loss": emd}
