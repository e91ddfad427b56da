"""Chamfer distance: hand-written CUDA nearest-neighbour kernel + plain
PyTorch version (counterpart of ``fenet/ops/chamfer.py``).

``chamfer_distance(xyz1, xyz2) -> (dist1, dist2, idx1, idx2)``: squared L2
nearest-neighbour distances in both directions and the first argmin indices,
the 4-tuple of the reference's CUDA extension. Forward only; the gradient
rule belongs to the training slice.

Each direction is one call of :func:`nearest_neighbour`. For CPU tensors it
runs the plain version :func:`_nn_ref`; for CUDA tensors it launches the
kernel in ``csrc/chamfer_nn.cu`` (:func:`nn_kernel`) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fenet_torch.ops import _build
from fenet_torch.ops.pairwise import pairwise_sqdist


def _nn_ref(a: torch.Tensor, b: torch.Tensor):
    """Plain version: for each point of a, min squared distance and the
    first argmin into b. (B,N,3), (B,M,3) -> (B,N) f32, (B,N) i32."""
    dist, idx = torch.min(pairwise_sqdist(a, b), dim=-1)
    return dist, idx.to(torch.int32)


def nn_kernel(a: torch.Tensor, b: torch.Tensor):
    """Launch the CUDA kernel (replaces ``fenet/ops/chamfer.py:_nn_kernel``).

    a (B,N,3), b (B,M,3) float32, contiguous, on one CUDA device ->
    (B,N) float32 min squared distances, (B,N) int32 first argmins.
    Counts its launches in ``nn_kernel.launches``.
    """
    _build.check_clouds(a, b, "chamfer_nn")
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    fn = _build.library("chamfer_nn").fenet_chamfer_nn
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), b.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                    bsz, n, m, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "chamfer_nn")
    nn_kernel.launches += 1
    return dist, idx


nn_kernel.launches = 0


def nearest_neighbour(a: torch.Tensor, b: torch.Tensor):
    """Directional NN of a into b: the plain version for CPU tensors, the
    CUDA kernel for anything else (which raises off a CUDA device)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _nn_ref(a, b)
    return nn_kernel(a, b)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Bidirectional chamfer distance.

    Args:
      xyz1: (B, N, 3) point cloud ("pred").
      xyz2: (B, M, 3) point cloud ("gt").

    Returns:
      ``(dist1, dist2, idx1, idx2)``: (B,N)/(B,M) squared NN distances and
      (B,N)/(B,M) int32 argmin indices.
    """
    xyz1 = xyz1.float()
    xyz2 = xyz2.float()
    dist1, idx1 = nearest_neighbour(xyz1, xyz2)
    dist2, idx2 = nearest_neighbour(xyz2, xyz1)
    return dist1, dist2, idx1, idx2
