"""Auction Earth Mover's Distance: hand-written CUDA kernels + plain PyTorch
version (counterpart of ``fenet/ops/emd.py``, N <= 8192).

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

For N <= 8192 the wrapper runs the plain version :func:`_auction_plain`
on CPU tensors and launches the kernel of ``csrc/emd_auction.cu``
(:func:`auction_kernel`) on CUDA tensors, through its resident entry point
for N <= 1024 and its streaming one above. Odd N runs as it is: no padding.
Above 8192 points, where fenet's Pallas kernel declines and fenet runs its
XLA auction, the op runs :func:`earth_mover_distance_ref`, the same dense
auction in plain torch on either device, and logs so once per N. The choice
is by N alone; the kernel wrapper itself raises above 8192.
"""

from __future__ import annotations

import ctypes
import logging

import torch

from fenet_torch.ops import _build
from fenet_torch.ops.pairwise import pairwise_sqdist, sqnorm

_NEG = -1e9  # "minus infinity" for masked maxima, kept finite as in fenet
# N of the kernel's resident entry point: one CTA of 1024 threads, one
# thread per row and per column (K3/K5).
RESIDENT_MAX_N = 1024
# Its streaming entry point takes 1024 < N <= MAX_N: 1024 threads own up to
# 8 rows and columns each (K4).
MAX_N = 8192
# The kernel keeps its winner keys in shared memory up to this N and in a
# (B, N) buffer from the wrapper above it (kSharedKeysMaxN in
# emd_auction.cu, which refuses to launch above it without the buffer).
SHARED_KEYS_MAX_N = 6400
# Eps-scaling phases the kernel takes (its phase table is a fixed array).
MAX_PHASES = 8
SCALE_FACTOR = 5.0
# The dense auction holds a few (B, N, N) tensors a step (the values, the
# bids, the one-hot of the columns bid): earth_mover_distance_ref runs as
# many elements at once as keep B·N² within DENSE_PAIRS (1 GiB of values).
DENSE_PAIRS = 1 << 28


def phase_eps(eps: float, scale_phases: int):
    """Each phase's eps, as fenet computes it in Python: eps·5^(P-1-p)."""
    return [eps * SCALE_FACTOR ** (scale_phases - 1 - p) for p in range(scale_phases)]


def gate_threshold(scale_thresh: float, n: int) -> float:
    """The adaptive gate's bound on the distinct-NN-column count, rounded to
    float32 as fenet's traced comparison rounds it."""
    return torch.tensor(scale_thresh * n, dtype=torch.float32).item()


def _row_bids(bids: torch.Tensor):
    """Each row's best bid, its column (the first on ties) and the best bid
    of the other columns, floored at _NEG as fenet masks the best column:
    (B, N, M) -> three (B, N)."""
    best, best_col = torch.max(bids, dim=2)
    second = bids.scatter(2, best_col[..., None], _NEG).amax(dim=2)
    return best, second, best_col


def _auction_loop(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                  scale_phases: int = 1, early_exit: bool = True,
                  scale_thresh: float = 0.0, trace: bool = False):
    """The dense masked auction of ``fenet/ops/emd.py:_auction_element``,
    batched over the leading axis, with its eps-scaling phases and gate.

    Returns ``(dist, assignment, bid_rows)``: bid_rows (B,) counts the row
    bids made over all phases and iterations, the work the auction's data
    asked for. A phase stops once no row of the batch is unassigned, with or
    without ``early_exit``: its remaining iterations would change nothing.
    With ``trace`` a fourth element lists, for each phase, the bidders of
    each iteration it ran, (iterations, B) int64; its sum is bid_rows.
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
    bidders = []
    for p, eps_p in enumerate(phase_eps(eps, scale_phases)):
        final = p == scale_phases - 1
        steps = []
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
            count = unass.sum(dim=1)
            bid_rows += count
            steps.append(count)

            best, better, best_col = _row_bids(value - price[:, None, :])
            inc = (best - better) + eps_p

            onehot = (rows == best_col[..., None]) & unass[..., None]  # (B, N, N)
            w = torch.where(onehot, inc[..., None], torch.full_like(value, _NEG))
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
        bidders.append(torch.stack(steps) if steps else bid_rows.new_zeros((0, b)))
    matched = x2.gather(1, ass.clamp_min(0)[..., None].expand(-1, -1, 3))
    out = sqnorm(x1 - matched), ass.to(torch.int32), bid_rows
    return out + (bidders,) if trace else out


def _auction_plain(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                   scale_phases: int = 1, early_exit: bool = True,
                   scale_thresh: float = 0.0):
    """Plain version of the auction kernel: (dist, assignment)."""
    dist, ass, _ = _auction_loop(x1, x2, eps, iters, scale_phases, early_exit,
                                 scale_thresh)
    return dist, ass


def earth_mover_distance_ref(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                             iters: int = 50, scale_phases: int = 1,
                             early_exit: bool = True, scale_thresh: float = 0.0):
    """The dense auction in plain torch at any N, on the tensors' device
    (fenet's ``earth_mover_distance_ref``, the XLA auction fenet runs where
    its Pallas kernel declines): :func:`_auction_loop` over as many
    elements at a time as keep their (N, N) values within DENSE_PAIRS.
    (dist, assignment) as :func:`earth_mover_distance`. Counts its calls in
    ``earth_mover_distance_ref.calls``."""
    earth_mover_distance_ref.calls += 1
    n = xyz1.shape[1]
    step = max(1, DENSE_PAIRS // (n * n))
    parts = [_auction_loop(xyz1[i:i + step], xyz2[i:i + step], eps, iters, scale_phases,
                           early_exit, scale_thresh)[:2]
             for i in range(0, xyz1.shape[0], step)]
    return torch.cat([d for d, _ in parts]), torch.cat([a for _, a in parts])


earth_mover_distance_ref.calls = 0
_warned_dense: set = set()


def _warn_dense_once(n: int) -> None:
    """Say once per N that the op runs the dense auction: its numbers are
    the same algorithm's, from another implementation than the kernel."""
    if n in _warned_dense:
        return
    _warned_dense.add(n)
    logging.getLogger("fenet_torch.ops.emd").warning(
        "EMD kernel declined for N=%d (needs N <= %d); running the dense auction "
        "(earth_mover_distance_ref, fenet's XLA reference auction: the same "
        "algorithm, an (N, N) value matrix an element in plain torch).", n, MAX_N)


def auction_kernel(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
                   scale_phases: int = 1, early_exit: bool = True,
                   scale_thresh: float = 0.0):
    """Launch the CUDA kernel (replaces ``fenet/ops/emd.py:_emd_kernel``,
    eps-scaling phases and adaptive gate included) of ``emd_auction.cu``:
    its resident entry point for N <= 1024, its streaming one for 1024 < N
    <= 8192.

    x1, x2 (B,N,3) float32, contiguous, on one CUDA device, N <= 8192 ->
    (B,N) float32 squared matched distances, (B,N) int32 assignment.
    Counts every launch in ``auction_kernel.launches`` and those of the
    streaming entry point also in ``auction_kernel.stream_launches``.
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
    stream = n > RESIDENT_MAX_N
    pointers = [x1.data_ptr(), x2.data_ptr(), dist.data_ptr(), ass.data_ptr()]
    if stream:
        # The per-column winner keys above SHARED_KEYS_MAX_N, cleared by the
        # kernel; below it they live in shared memory and the pointer is null.
        keys = (torch.empty((bsz, n), dtype=torch.int64, device=x1.device)
                if n > SHARED_KEYS_MAX_N else None)
        pointers.append(None if keys is None else keys.data_ptr())
        fn = _build.library("emd_auction").fenet_emd_auction_stream
    else:
        fn = _build.library("emd_auction").fenet_emd_auction
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x1.device):
        status = fn(*pointers, bsz, n, ctypes.addressof(eps_table), scale_phases, iters,
                    int(early_exit), int(adaptive),
                    gate_threshold(scale_thresh, n) if adaptive else 0.0,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "emd_auction_stream" if stream else "emd_auction")
    auction_kernel.launches += 1
    auction_kernel.stream_launches += int(stream)
    return dist, ass


auction_kernel.launches = 0
auction_kernel.stream_launches = 0


def root_mismatches(device: torch.device):
    """Hold the kernel's square root (``root_fast``, with ``__fsqrt_rn(max(d,
    0))`` outside its range, as the bid scan takes it) against
    ``__fsqrt_rn(max(d, 0))`` on the card, over all 2^32 float bit patterns:
    ``(patterns whose bits differ, the lowest of them or None)``."""
    out = torch.tensor([0, 1 << 32], dtype=torch.int64, device=device)
    fn = _build.library("emd_auction").fenet_emd_root_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        status = fn(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "emd_root_check")
    bad, lowest = out.tolist()
    return bad, (lowest if bad else None)


class _EarthMoverDistance(torch.autograd.Function):
    """The auction forward; the backward treats the assignment as fixed."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters, scale_phases, early_exit, scale_thresh):
        args = (xyz1, xyz2, eps, iters, scale_phases, early_exit, scale_thresh)
        if xyz1.shape[1] > MAX_N:
            _warn_dense_once(xyz1.shape[1])
            dist, ass = earth_mover_distance_ref(*args)
        elif xyz1.device.type == "cpu" and xyz2.device.type == "cpu":
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
