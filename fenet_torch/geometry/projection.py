"""Differentiable silhouette projection (counterpart of
``fenet/geometry/projection.py``), on the device end to end.

As in fenet, and unlike the reference (which detaches both inputs), the
gradient flows through the predicted cloud. The splat is the separable
x and y gaussians and one batched product ``kx^T @ ky``, in plain PyTorch:
fenet leaves it to XLA too, so it has no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from fenet_torch.geometry.pointcloud import average_pcl, outlier, scale2one

# Blender-derived intrinsics for the 64x64 projection grid.
_K = np.array([[120.0, 0.0, -32.0], [0.0, 120.0, -32.0], [0.0, 0.0, 1.0]],
              np.float32)
_CAMERA_DISTANCE = 2.5


def apply_kernel(x: torch.Tensor, sigma_sq: float = 0.5) -> torch.Tensor:
    """Unnormalised gaussian exp(-x^2 / 2 sigma^2)."""
    return torch.exp(-(x ** 2) / (2.0 * sigma_sq))


def cont_proj(pcl: torch.Tensor, grid_h: int, grid_w: int, sigma_sq: float = 0.5,
              squash: bool = False) -> torch.Tensor:
    """Gaussian-splat orthographic silhouette of (B, N, 3) clouds with x, y
    in (-1, 1): (B, H, W), the sum over points of kx[b, n, h]·ky[b, n, w].

    The sum is not a probability: cells under overlapping points exceed 1.
    ``squash=True`` applies tanh to it (the CAPNet composition), mapping it
    into [0, 1).
    """
    x = (pcl[..., 0] + 1.0) * grid_h / 2.0  # (B, N)
    y = (pcl[..., 1] + 1.0) * grid_w / 2.0
    gh = torch.arange(grid_h, dtype=pcl.dtype, device=pcl.device)
    gw = torch.arange(grid_w, dtype=pcl.dtype, device=pcl.device)
    kx = apply_kernel(x[..., None] - gh, sigma_sq)  # (B, N, H)
    ky = apply_kernel(y[..., None] - gw, sigma_sq)  # (B, N, W)
    out = torch.bmm(kx.transpose(1, 2), ky)
    return torch.tanh(out) if squash else out


def disc_proj(pcl: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """Hard scatter silhouette: 1 at every cell a point truncates into."""
    ix = pcl[..., 0].to(torch.int32).clamp(0, grid_h - 1).long()
    iy = pcl[..., 1].to(torch.int32).clamp(0, grid_w - 1).long()
    b = pcl.shape[0]
    grid = torch.zeros((b, grid_h, grid_w), dtype=torch.float32, device=pcl.device)
    bidx = torch.arange(b, device=pcl.device)[:, None].expand_as(ix)
    return grid.index_put((bidx, ix, iy), torch.ones((), device=pcl.device))


def world2cam(xyz: torch.Tensor, az, el, d: float = _CAMERA_DISTANCE) -> torch.Tensor:
    """World to camera coordinates. xyz (B, N, 3); az, el (B,) tensors of
    radians or numbers. Rotation R = R_el @ R_az in the reference's matrix
    layout, applied to xyz - [0, 0, -d]. Numbers are filled in on the
    device: copying them there would block the host."""
    az, el = (a.to(xyz).expand(xyz.shape[0]) if torch.is_tensor(a)
              else xyz.new_full(xyz.shape[:1], float(a)) for a in (az, el))
    one, zero = torch.ones_like(az), torch.zeros_like(az)
    rot_az = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, torch.cos(az), -torch.sin(az)], -1),
        torch.stack([zero, torch.sin(az), torch.cos(az)], -1),
    ], dim=1)  # (B, 3, 3)
    rot_el = torch.stack([
        torch.stack([torch.cos(el), zero, torch.sin(el)], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-torch.sin(el), zero, torch.cos(el)], -1),
    ], dim=1)
    rot = torch.bmm(rot_el, rot_az)
    t = F.pad(xyz.new_full((1,), -d), (2, 0))  # [0, 0, -d]
    return torch.einsum("bij,bnj->bni", rot, xyz - t)


def perspective_transform(xyz: torch.Tensor) -> torch.Tensor:
    """Camera to image coordinates with the fixed K: K·x's x and y divided
    by |z| of the *input*, and |(K·x)_z| as the output z. K's entries enter
    as Python scalars: a K tensor copied to the card would block the host
    on every call."""
    x, y, z = xyz.unbind(-1)
    proj = torch.stack([kx * x + ky * y + kz * z for kx, ky, kz in _K.tolist()], dim=-1)
    xy = proj[..., :2] / xyz[..., 2:3].abs()
    return torch.cat([xy, proj[..., 2:3].abs()], dim=-1)


def project_silhouettes(pre_points: torch.Tensor, points: torch.Tensor, grid_h: int = 64,
                        grid_w: int = 64, sigma_sq: float = 0.5, az: float = 0.0,
                        el: float = 0.0, squash: bool = False):
    """Project the predicted (B, N, 3) cloud ``pre_points`` (gradients flow)
    and the GT cloud ``points`` to soft silhouettes, (B, H, W) each: camera
    transform, perspective, batch-global centring, the outlier clamp, the
    per-axis scale and the splat. The finetune loss calls it at
    az = el = 0, as the reference's transform() does."""

    def pipeline(p):
        p = world2cam(p, az, el)
        p = perspective_transform(p)
        p, xm, ym, zm = average_pcl(p)
        p = outlier(p, xm, ym, zm)
        p = scale2one(p)
        return cont_proj(p, grid_h, grid_w, sigma_sq, squash=squash)

    return pipeline(pre_points), pipeline(points)
