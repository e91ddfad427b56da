"""Batched pairwise squared distance, the shared primitive under chamfer, EMD
and ICP (counterpart of ``fenet/ops/pairwise.py``).

``||a-b||^2 = |a|^2 + |b|^2 - 2 a.b`` in float32, clamped at 0. The squared
norms are summed x, then y, then z, the order the CUDA kernels in
``fenet_torch/csrc`` use, so a kernel and this function agree bit for bit
wherever the cross term is exact.
"""

from __future__ import annotations

import torch


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): ``(x0*x0 + x1*x1) + x2*x2``."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 distances.

    Args:
      a: (..., N, 3) point cloud.
      b: (..., M, 3) point cloud.

    Returns:
      (..., N, M) squared distances, clamped at 0 (the matmul identity can go
      slightly negative under float32 rounding).
    """
    ab = torch.matmul(a, b.transpose(-1, -2))
    d = (sqnorm(a)[..., :, None] + sqnorm(b)[..., None, :]) - 2.0 * ab
    return d.clamp_min(0.0)
