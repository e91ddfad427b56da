"""Auction Earth Mover's Distance: hand-written CUDA kernel + plain PyTorch
version (counterpart of ``fenet/ops/emd.py``, resident mode, N <= 1024).

``earth_mover_distance(xyz1, xyz2, eps, iters, scale_phases, early_exit,
scale_thresh) -> (dist, assignment)``: per-point squared matched distances
(B, N) and the int32 gt index matched to each pred point (B, N). The
assignment is approximate and need not be bijective. The gradient flows to
xyz1 only, ``2·g·(x1 − x2[assignment])``, as in the reference's CUDA op.

The auction, as in the JAX package: each iteration every unassigned row i
bids on its best column with increment ``best - second_best + eps``, where
a bid is ``3 - ||x1_i - x2_j|| - price_j``. Each column goes to its largest
increment, the first row on ties; winners commit, the previous owners of
won columns are evicted, and won columns' prices rise by the winning
increment. The last iteration commits every remaining bidder.

Eps-scaling (``scale_phases`` P > 1) runs the auction at eps·5^(P-1), ...,
eps: prices carry over between phases, assignments reset, and only the final
phase forces the commit on its last iteration. With ``scale_thresh`` > 0 the
high-eps phases run only for batch elements whose nearest-neighbour
competition is high: fewer than ``scale_thresh·N`` distinct gt columns are
some row's nearest (the argmax of the value at price 0, first column on
ties). When they are skipped the result is the fixed-eps auction's.
``early_exit`` stops a phase once every row is assigned; without it the
kernel runs every iteration, as the reference driver does. The iterations
after that point change nothing, so the results are the same either way.

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
# Eps-scaling phases the kernel takes (its phase table is a fixed array).
MAX_PHASES = 8
SCALE_FACTOR = 5.0


def phase_eps(eps: float, scale_phases: int):
    """Each phase's eps, as fenet computes it in Python: eps·5^(P-1-p)."""
    return [eps * SCALE_FACTOR ** (scale_phases - 1 - p) for p in range(scale_phases)]


def gate_threshold(scale_thresh: float, n: int) -> float:
    """The adaptive gate's bound on the distinct-NN-column count, rounded to
    float32 as fenet's traced comparison rounds it."""
    return torch.tensor(scale_thresh * n, dtype=torch.float32).item()


def _auction_loop(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                  scale_phases: int = 1, early_exit: bool = True,
                  scale_thresh: float = 0.0):
    """The dense masked auction of ``fenet/ops/emd.py:_auction_element``,
    batched over the leading axis, with its eps-scaling phases and gate.

    Returns ``(dist, assignment, bid_rows)``: bid_rows (B,) counts the row
    bids made over all phases and iterations, the work the auction's data
    asked for. A phase stops once no row of the batch is unassigned, with or
    without ``early_exit``: its remaining iterations would change nothing.
    """
    b, n, _ = x1.shape
    value = 3.0 - torch.sqrt(pairwise_sqdist(x1, x2))  # (B, N, N)
    rows = torch.arange(n, device=x1.device)
    price = torch.zeros((b, n), dtype=torch.float32, device=x1.device)
    bid_rows = torch.zeros((b,), dtype=torch.int64, device=x1.device)
    enabled = torch.ones((b,), dtype=torch.bool, device=x1.device)
    if scale_phases > 1 and scale_thresh > 0.0:
        nn_col = torch.argmax(value, dim=2)  # first column on ties
        hit = torch.zeros((b, n), dtype=torch.int64, device=x1.device)
        hits = hit.scatter_(1, nn_col, 1).sum(dim=1)
        enabled = hits.to(torch.float32) < gate_threshold(scale_thresh, n)
    for p, eps_p in enumerate(phase_eps(eps, scale_phases)):
        final = p == scale_phases - 1
        # A skipped phase's rows start out assigned (to a dummy column): they
        # never bid, so nothing of their element changes.
        ass = torch.full((b, n), -1, dtype=torch.int64, device=x1.device)
        if not final:
            ass = torch.where(enabled[:, None], ass, 0)
        for it in range(iters):
            unass = ass < 0
            if not bool(unass.any()):
                break
            last = final and it == iters - 1
            bid_rows += unass.sum(dim=1)

            bids = value - price[:, None, :]
            best, best_col = torch.max(bids, dim=2)
            better = bids.scatter(2, best_col[..., None], _NEG).amax(dim=2)
            inc = (best - better) + eps_p

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


def _auction_plain(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                   scale_phases: int = 1, early_exit: bool = True,
                   scale_thresh: float = 0.0):
    """Plain version of the auction kernel: (dist, assignment)."""
    dist, ass, _ = _auction_loop(x1, x2, eps, iters, scale_phases, early_exit,
                                 scale_thresh)
    return dist, ass


def auction_kernel(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                   scale_phases: int = 1, early_exit: bool = True,
                   scale_thresh: float = 0.0):
    """Launch the CUDA kernel (replaces ``fenet/ops/emd.py:_emd_kernel`` in
    its resident mode, eps-scaling phases and adaptive gate included).

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
    if not 1 <= scale_phases <= MAX_PHASES:
        raise ValueError(f"emd_auction: scale_phases {scale_phases} not in [1, {MAX_PHASES}]")
    dist = torch.empty((bsz, n), dtype=torch.float32, device=x1.device)
    ass = torch.empty((bsz, n), dtype=torch.int32, device=x1.device)
    eps_table = (ctypes.c_float * scale_phases)(*phase_eps(eps, scale_phases))
    adaptive = scale_phases > 1 and scale_thresh > 0.0
    fn = _build.library("emd_auction").fenet_emd_auction
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x1.device):
        status = fn(x1.data_ptr(), x2.data_ptr(), dist.data_ptr(), ass.data_ptr(),
                    bsz, n, ctypes.addressof(eps_table), scale_phases, iters,
                    int(early_exit), int(adaptive),
                    gate_threshold(scale_thresh, n) if adaptive else 0.0,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "emd_auction")
    auction_kernel.launches += 1
    return dist, ass


auction_kernel.launches = 0


class _EarthMoverDistance(torch.autograd.Function):
    """The auction forward; the backward treats the assignment as fixed."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters, scale_phases, early_exit, scale_thresh):
        args = (xyz1, xyz2, eps, iters, scale_phases, early_exit, scale_thresh)
        if xyz1.device.type == "cpu" and xyz2.device.type == "cpu":
            dist, ass = _auction_plain(*args)
        else:
            dist, ass = auction_kernel(*args)
        ctx.mark_non_differentiable(ass)
        ctx.save_for_backward(xyz1, xyz2, ass)
        return dist, ass

    @staticmethod
    def backward(ctx, grad_dist, _grad_ass):
        xyz1, xyz2, ass = ctx.saved_tensors
        matched = xyz2.gather(1, ass.long()[..., None].expand(-1, -1, 3))
        dxyz1 = 2.0 * grad_dist[..., None] * (xyz1 - matched)
        dxyz2 = torch.zeros_like(xyz2) if ctx.needs_input_grad[1] else None
        return dxyz1, dxyz2, None, None, None, None, None


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         eps: float = 0.005, iters: int = 50,
                         scale_phases: int = 1, early_exit: bool = True,
                         scale_thresh: float = 0.0):
    """Approximate EMD matching via the auction algorithm.

    Args:
      xyz1: (B, N, 3) predicted cloud (the gradient flows here only).
      xyz2: (B, N, 3) ground-truth cloud.
      eps: price-increment slack (train 0.05, eval 0.005).
      iters: most auction iterations per phase (train 3000, eval 50), >= 1.
      scale_phases: 1 = the reference's fixed-eps auction; P > 1 runs
        phases at eps·5^(P-1) ... eps with carried prices.
      early_exit: stop a phase once every row is assigned (same results).
      scale_thresh: > 0 gates the high-eps phases per batch element on
        nearest-neighbour competition (see the module docstring).

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
    if scale_phases < 1:
        raise ValueError(f"EMD needs scale_phases >= 1, got {scale_phases}")
    return _EarthMoverDistance.apply(xyz1.float(), xyz2.float(), eps, iters,
                                     scale_phases, early_exit, scale_thresh)
