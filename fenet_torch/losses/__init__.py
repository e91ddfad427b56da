"""Training losses: the chamfer/EMD facade, the Sinkhorn loss, the
silhouette projection loss and the F-score (counterpart of
``fenet/losses``)."""

from fenet_torch.losses.facade import (
    Loss,
    chamfer_loss,
    emd_loss,
    point_loss,
    point_loss_test,
    scheduled_total_loss,
)
from fenet_torch.losses.fscore import fscore
from fenet_torch.losses.projection import get_loss_proj, grid_dist
from fenet_torch.losses.sinkhorn import batch_emd_loss, sinkhorn_distance

__all__ = [
    "Loss",
    "batch_emd_loss",
    "chamfer_loss",
    "emd_loss",
    "fscore",
    "get_loss_proj",
    "grid_dist",
    "point_loss",
    "point_loss_test",
    "scheduled_total_loss",
    "sinkhorn_distance",
]
