"""Silhouette projection losses (counterpart of ``fenet/losses/projection.py``).

fenet's fixes of the reference are kept: every variant takes
(pred = input, gt = target), and the min-distance affinity terms index the
source mask at the far cell. ``bce_prob`` floors the argument of its second
log at 1e-7: the splat silhouette is a sum, cells under overlapping points
exceed 1, and without the floor the gradient at pred = 1 - eps is unbounded
(one finetune step then goes NaN). The floor is ``torch.maximum`` against a
tensor, which halves the gradient at a tie as ``jnp.maximum`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def grid_dist(grid_h: int, grid_w: int) -> np.ndarray:
    """All-pairs euclidean distances between grid cells, (H, W, H, W)."""
    x, y = np.meshgrid(range(grid_h), range(grid_w), indexing="ij")
    grid = np.stack([x.ravel(), y.ravel()], axis=1).astype(np.float32)
    d = np.sqrt(((grid[:, None, :] - grid[None, :, :]) ** 2).sum(-1))
    return d.reshape(grid_h, grid_w, grid_h, grid_w)


def _bce(pred, gt, eps=1e-7):
    pred = pred.clamp(eps, 1 - eps)
    return -(gt * torch.log(pred) + (1 - gt) * torch.log(1 - pred))


def _bce_logits(pred, gt):
    return pred.clamp_min(0) - pred * gt + torch.log1p(torch.exp(-pred.abs()))


def get_loss_proj(
    pred: torch.Tensor,
    gt: torch.Tensor,
    loss_type: str = "bce",
    w: float = 1.0,
    min_dist_loss: bool = False,
    dist_mat: Optional[torch.Tensor] = None,
    grid_h: int = 64,
    grid_w: int = 64,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Projection loss between (B, H, W) silhouettes.

    Returns (mean loss, min_dist, min_dist_inv); the last two are the
    forward and backward grid-distance affinity terms, (B, H, W) each, and
    None unless ``min_dist_loss``. They materialise (B, H, W, H, W) float32
    tensors: 67 MB an element at a 64x64 grid.
    """
    if loss_type == "bce":
        loss = _bce(pred, gt)
    elif loss_type == "weighted_bce":
        loss = _bce_logits(pred, gt)
    elif loss_type == "bce_prob":
        epsilon = 1e-8
        floor = pred.new_full((), 1e-7)
        loss = -gt * torch.log(pred + epsilon) * w - (1 - gt) * torch.log(
            torch.maximum((1 - pred - epsilon).abs(), floor))
    else:
        raise ValueError(f"unknown loss_type {loss_type!r}")

    min_dist = min_dist_inv = None
    if min_dist_loss:
        if dist_mat is None:
            dist_mat = torch.from_numpy(grid_dist(grid_h, grid_w)).to(pred.device)
        dmat = dist_mat + 1.0
        # (B, H, W) masks against the (H, W, H', W') distances; cells outside
        # a silhouette are pushed to ~1e6.
        gt_w = gt[:, :, :, None, None]
        pred_src = pred[:, None, None, :, :]  # the value at the far cell (h', w')
        pred_mask_src = pred_src + (1.0 - pred_src) * 1e6
        gt_mask = gt_w + (1.0 - gt_w) * 1e6
        dist_masked_inv = gt_w * dmat[None] * pred_mask_src
        dist_masked = gt_mask * dmat[None] * pred_src
        min_dist = dist_masked.amin(dim=(3, 4))
        min_dist_inv = dist_masked_inv.amin(dim=(3, 4))
    return loss.mean(), min_dist, min_dist_inv
