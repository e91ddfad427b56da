"""Chamfer distance: hand-written CUDA nearest-neighbour kernel + plain
PyTorch version (counterpart of ``fenet/ops/chamfer.py``).

``chamfer_distance(xyz1, xyz2) -> (dist1, dist2, idx1, idx2)``: squared L2
nearest-neighbour distances in both directions and the first argmin indices,
the 4-tuple of the reference's CUDA extension. The gradient is the
reference's (``fenet/ops/chamfer.py:_chamfer_bwd``): with
``grad1 = 2·g1·(x1 − x2[idx1])`` and ``grad2 = 2·g2·(x2 − x1[idx2])``,
``dxyz1 = grad1 − scatter(idx2, grad2)`` and ``dxyz2 = grad2 −
scatter(idx1, grad1)``; no gradient flows through the indices. The scatter
is deterministic on the card too (:func:`scatter_rows`).

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


def scatter_rows(idx: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """``out[b, idx[b, k]] += src[b, k]`` into zeros (B, n, 3), the same bits
    on every run. idx (B, K) int, src (B, K, 3).

    ``index_add_`` and ``scatter_add_`` on CUDA add with atomics, in an order
    that changes from run to run. ``index_put_(accumulate=True)`` on CUDA
    always takes PyTorch's sort-based path instead: a stable sort groups the
    rows by target and each group is summed in order, with no host sync.
    """
    batch = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)
    out = src.new_zeros((idx.shape[0], n, 3))
    return out.index_put_((batch, idx.long()), src, accumulate=True)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx.long()[..., None].expand(-1, -1, 3))


class _ChamferDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        dist1, idx1 = nearest_neighbour(xyz1, xyz2)
        dist2, idx2 = nearest_neighbour(xyz2, xyz1)
        ctx.mark_non_differentiable(idx1, idx2)
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        return dist1, dist2, idx1, idx2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        grad1 = 2.0 * g1[..., None] * (xyz1 - _gather_rows(xyz2, idx1))
        grad2 = 2.0 * g2[..., None] * (xyz2 - _gather_rows(xyz1, idx2))
        dxyz1 = grad1 + scatter_rows(idx2, -grad2, xyz1.shape[1])
        dxyz2 = grad2 + scatter_rows(idx1, -grad1, xyz2.shape[1])
        return dxyz1, dxyz2


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Bidirectional chamfer distance.

    Args:
      xyz1: (B, N, 3) point cloud ("pred").
      xyz2: (B, M, 3) point cloud ("gt").

    Returns:
      ``(dist1, dist2, idx1, idx2)``: (B,N)/(B,M) squared NN distances and
      (B,N)/(B,M) int32 argmin indices.
    """
    return _ChamferDistance.apply(xyz1.float(), xyz2.float())
