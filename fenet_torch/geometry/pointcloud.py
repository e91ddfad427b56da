"""Point-cloud normalisation and alignment helpers (counterpart of
``fenet/geometry/pointcloud.py``): pure functions on tensors, where the
reference mutates its tensors in place.

Gradient ties follow fenet's: ``scale2one``'s extents use ``amax``/``amin``,
which split the gradient evenly among tied points as JAX's reductions do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rotate(xyz: np.ndarray, xangle: float = 0, yangle: float = 0,
           zangle: float = 0) -> np.ndarray:
    """Compose x/y/z rotations and apply them on the right (numpy).

    The reference's y rotation has the transposed sign convention (-sin in
    the [0, 2] slot); kept for data parity.
    """
    rx = np.array([
        [1, 0, 0],
        [0, np.cos(xangle), -np.sin(xangle)],
        [0, np.sin(xangle), np.cos(xangle)],
    ])
    ry = np.array([
        [np.cos(yangle), 0, -np.sin(yangle)],
        [0, 1, 0],
        [np.sin(yangle), 0, np.cos(yangle)],
    ])
    rz = np.array([
        [np.cos(zangle), -np.sin(zangle), 0],
        [np.sin(zangle), np.cos(zangle), 0],
        [0, 0, 1],
    ])
    return xyz.dot(rx.dot(ry).dot(rz))


def preprocess_pcl_gt(pcl: torch.Tensor) -> torch.Tensor:
    """Axis swap and flip that align GT clouds to the renderer's frame: swap
    x and z, then x and y, and negate the new x and y."""
    x, y, z = pcl[..., 0], pcl[..., 1], pcl[..., 2]
    return torch.stack([-y, -z, x], dim=-1)


def average_pcl(p: torch.Tensor):
    """Centre a batch of clouds by the *batch-global* per-axis mean (over
    batch and points, as the reference does). Returns (centred, mean_x,
    mean_y, mean_z)."""
    mean = p.mean(dim=(0, 1))
    return p - mean, mean[0], mean[1], mean[2]


def outlier(p: torch.Tensor, x_mean, y_mean, z_mean) -> torch.Tensor:
    """Set the most extreme point per (element, axis) to that axis's
    pre-centring mean, at the first argmax: the net effect of the
    reference's aliased in-place loops. Out of place: the overwritten
    entries take no gradient from ``p``, the means they take do."""
    means = torch.stack([torch.as_tensor(m, dtype=p.dtype, device=p.device)
                         for m in (x_mean, y_mean, z_mean)])
    idx = p.argmax(dim=1)  # (B, 3), the first maximum
    bidx = torch.arange(p.shape[0], device=p.device)[:, None]
    aidx = torch.arange(3, device=p.device)[None, :]
    return p.index_put((bidx, idx, aidx), means.expand(p.shape[0], 3))


def scale2one(p: torch.Tensor) -> torch.Tensor:
    """Per-axis scale by 2/extent, without re-centring (the reference leaves
    its centring lines commented out)."""
    delta = p.amax(dim=1, keepdim=True) - p.amin(dim=1, keepdim=True)
    return 2.0 * p / delta.abs()


def normalize_to_unit_cube(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shift and scale a batch of clouds into [0, 1]^3, the EMD kernel's
    expected input range. Returns (scaled, mins, scale)."""
    mins = p.amin(dim=1, keepdim=True)
    maxs = p.amax(dim=1, keepdim=True)
    scale = torch.maximum((maxs - mins).amax(dim=2, keepdim=True), p.new_full((), 1e-8))
    return (p - mins) / scale, mins, scale
