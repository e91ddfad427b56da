"""Auction Earth Mover's Distance: hand-written CUDA kernel + plain PyTorch
version (counterpart of ``fenet/ops/emd.py``, resident fixed-eps mode).

``earth_mover_distance(xyz1, xyz2, eps, iters) -> (dist, assignment)``:
per-point squared matched distances (B, N) and the int32 gt index matched to
each pred point (B, N). The assignment is approximate and need not be
bijective. Forward only; the gradient rule belongs to the training slice.

The auction, as in the JAX package: each iteration every unassigned row i
bids on its best column with increment ``best - second_best + eps``, where
a bid is ``3 - ||x1_i - x2_j|| - price_j``. Each column goes to its largest
increment, the first row on ties; winners commit, the previous owners of
won columns are evicted, and won columns' prices rise by the winning
increment. The last iteration commits every remaining bidder. The loop stops
early once every row is assigned.

For CPU tensors the wrapper runs the plain version :func:`_auction_plain`;
for CUDA tensors it launches ``csrc/emd_auction.cu`` (:func:`auction_kernel`)
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fenet_torch.ops import _build
from fenet_torch.ops.pairwise import pairwise_sqdist, sqnorm

_NEG = -1e9  # "minus infinity" for masked maxima, kept finite as in fenet
# Rows of one batch element the kernel holds: one CTA of 1024 threads, one
# thread per row and per column.
MAX_N = 1024


def _auction_loop(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int):
    """The dense masked auction of ``fenet/ops/emd.py:_auction_element``,
    batched over the leading axis.

    Returns ``(dist, assignment, bid_rows)``: bid_rows (B,) counts the row
    bids made over all iterations, the work the auction's data asked for.
    """
    b, n, _ = x1.shape
    value = 3.0 - torch.sqrt(pairwise_sqdist(x1, x2))  # (B, N, N)
    rows = torch.arange(n, device=x1.device)
    ass = torch.full((b, n), -1, dtype=torch.int64, device=x1.device)
    price = torch.zeros((b, n), dtype=torch.float32, device=x1.device)
    bid_rows = torch.zeros((b,), dtype=torch.int64, device=x1.device)
    for it in range(iters):
        unass = ass < 0
        if not bool(unass.any()):
            break
        last = it == iters - 1
        bid_rows += unass.sum(dim=1)

        bids = value - price[:, None, :]
        best, best_col = torch.max(bids, dim=2)
        better = bids.scatter(2, best_col[..., None], _NEG).amax(dim=2)
        inc = (best - better) + eps

        onehot = (rows == best_col[..., None]) & unass[..., None]  # (B, N, N)
        w = torch.where(onehot, inc[..., None], torch.full_like(bids, _NEG))
        winner_inc, winner_row = torch.max(w, dim=1)
        com_col = onehot.any(dim=1)

        if last:
            commit = unass
            evicted = torch.zeros_like(unass)
        else:
            commit = unass & (winner_row.gather(1, best_col) == rows)
            evicted = (ass >= 0) & com_col.gather(1, ass.clamp_min(0))
            price = price + torch.where(com_col, winner_inc, torch.zeros_like(price))
        ass = torch.where(commit, best_col, torch.where(evicted, -1, ass))
    matched = x2.gather(1, ass.clamp_min(0)[..., None].expand(-1, -1, 3))
    return sqnorm(x1 - matched), ass.to(torch.int32), bid_rows


def _auction_plain(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int):
    """Plain version of the auction kernel: (dist, assignment)."""
    dist, ass, _ = _auction_loop(x1, x2, eps, iters)
    return dist, ass


def auction_kernel(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int):
    """Launch the CUDA kernel (replaces ``fenet/ops/emd.py:_emd_kernel`` in
    its resident fixed-eps mode).

    x1, x2 (B,N,3) float32, contiguous, on one CUDA device, N <= 1024 ->
    (B,N) float32 squared matched distances, (B,N) int32 assignment.
    Counts its launches in ``auction_kernel.launches``.
    """
    _build.check_clouds(x1, x2, "emd_auction")
    bsz, n = x1.shape[0], x1.shape[1]
    if x1.shape != x2.shape or n > MAX_N:
        raise ValueError(
            f"emd_auction: clouds of shapes {tuple(x1.shape)} and "
            f"{tuple(x2.shape)}, needs equal (B, N, 3) with N <= {MAX_N}")
    dist = torch.empty((bsz, n), dtype=torch.float32, device=x1.device)
    ass = torch.empty((bsz, n), dtype=torch.int32, device=x1.device)
    fn = _build.library("emd_auction").fenet_emd_auction
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x1.device):
        status = fn(x1.data_ptr(), x2.data_ptr(), dist.data_ptr(), ass.data_ptr(),
                    bsz, n, eps, iters, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "emd_auction")
    auction_kernel.launches += 1
    return dist, ass


auction_kernel.launches = 0


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         eps: float = 0.005, iters: int = 50):
    """Approximate EMD matching via the auction algorithm.

    Args:
      xyz1: (B, N, 3) predicted cloud.
      xyz2: (B, N, 3) ground-truth cloud.
      eps: price-increment slack (train 0.05, eval 0.005).
      iters: most auction iterations (train 3000, eval 50), at least 1.

    Returns:
      ``(dist, assignment)``: (B, N) squared matched distances and (B, N)
      int32 gt indices.
    """
    if xyz1.shape != xyz2.shape:
        raise ValueError(
            f"EMD requires same-size clouds, got {tuple(xyz1.shape)} vs "
            f"{tuple(xyz2.shape)}")
    if iters < 1:
        raise ValueError(f"EMD needs iters >= 1, got {iters}")
    xyz1 = xyz1.float()
    xyz2 = xyz2.float()
    if xyz1.device.type == "cpu" and xyz2.device.type == "cpu":
        return _auction_plain(xyz1, xyz2, eps, iters)
    return auction_kernel(xyz1, xyz2, eps, iters)
