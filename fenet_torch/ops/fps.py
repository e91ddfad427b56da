"""Farthest-point sampling and point gathering in plain PyTorch, on the
tensor's device (counterpart of ``fenet/ops/fps.py``).

The loop runs ``npoint`` times with no host sync: the current farthest
index stays on the device and is used through ``gather``, so on the card
the host only enqueues launches. The indices equal fenet's: the start is
index 0 (``ran``) or 1, the distance starts at 1e10 in float32, and the
argmax takes the first of tied maxima.

The squared distance has fenet's roundings. XLA fuses fenet's
``jnp.sum((xyz - c) ** 2, -1)`` into fused multiply-adds,
``fma(dz, dz, fma(dy, dy, dx * dx))``, each rounded once to float32, and a
one-ulp difference flips a near-tie at the argmax. PyTorch has no fused
multiply-add op, so :func:`_fma_square` computes one exactly in float64,
which gives the same bits on the CPU and on the card. (XLA on the CPU also
flushes float32 denormals to zero; the port keeps them. A squared distance
is denormal only for coordinates within ~1e-19 of each other.)
"""

from __future__ import annotations

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points (B, N, C), idx (B, S) -> (B, S, C)."""
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _fma_square(sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sq + c`` rounded once to float32, for ``sq`` the exact float64
    square of a float32 and ``c`` >= 0 float32: a fused multiply-add.

    The float64 sum ``s`` rounds, and two-sum gives its error exactly.
    Rounded to odd (an inexact ``s`` with an even last bit moves one step
    toward the exact sum), a float64 rounds to float32 as the exact sum
    does, since 53 >= 2 * 24 + 2 bits. All values are >= 0, so a step is
    +-1 on the bits.
    """
    c = c.double()
    s = sq + c
    t = s - sq
    err = (sq - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    odd = (bits - (err < 0).long()) | (err != 0).long()
    return odd.view(torch.float64).float()


def farthest_point_sample(xyz: torch.Tensor, npoint: int, ran: bool = True) -> torch.Tensor:
    """Greedy farthest-point sampling of float32 xyz (B, N, 3).

    ``ran`` picks the seed point: index 0 if True, 1 if False (the
    reference's randint(0, 1) / randint(1, 2), which are constants).
    Returns (B, npoint) int64 indices into ``xyz``.
    """
    b, n, _ = xyz.shape
    centroids = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    distance = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    farthest = torch.full((b, 1), 0 if ran else 1, dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        centroids[:, i : i + 1] = farthest
        centroid = torch.gather(xyz, 1, farthest[..., None].expand(-1, -1, 3))
        d = (xyz - centroid).double()
        sq = d * d  # exact
        dist = _fma_square(sq[..., 2], _fma_square(sq[..., 1], sq[..., 0].float()))
        torch.minimum(distance, dist, out=distance)
        farthest = torch.argmax(distance, dim=-1, keepdim=True)
    return centroids
