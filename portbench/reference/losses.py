"""The reference's losses and metrics in plain PyTorch: squared distances,
chamfer, the auction EMD of the reference's CUDA op (fixed eps, dense
masked bids, first row and first column on ties, the last iteration
commits every bidder) and the annealed log-domain Sinkhorn loss with its
detached plan. Batches are taken ``rows`` elements at a time where the
(B, N, M) arrays would not fit.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import FLOAT32, Operands

_NEG = -1e9


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def pairwise(a: torch.Tensor, b: torch.Tensor, ops: Operands = FLOAT32) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances,
    |a|^2 + |b|^2 - 2 a.b clamped at 0."""
    ab = torch.matmul(ops(a), ops(b).transpose(-1, -2))
    return ((sqnorm(a)[..., :, None] + sqnorm(b)[..., None, :]) - 2.0 * ab).clamp_min(0.0)


def nearest(a: torch.Tensor, b: torch.Tensor, ops: Operands = FLOAT32):
    """For each point of a its nearest point of b: (squared distance, first
    index), both (B, N)."""
    return torch.min(pairwise(a, b, ops), dim=-1)


def chamfer(a: torch.Tensor, b: torch.Tensor, ops: Operands = FLOAT32):
    """(d1 (B, N), d2 (B, M)): squared distances to the nearest point of
    the other cloud, differentiable in both clouds with the nearest
    indices held fixed."""
    with torch.no_grad():
        _, i1 = nearest(a, b, ops)
        _, i2 = nearest(b, a, ops)
    d1 = sqnorm(a - b.gather(1, i1[..., None].expand(-1, -1, 3)))
    d2 = sqnorm(b - a.gather(1, i2[..., None].expand(-1, -1, 3)))
    return d1, d2


@torch.no_grad()
def auction(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
            ops: Operands = FLOAT32, rows: int = 32) -> torch.Tensor:
    """The auction's assignment (B, N) int64 of x1's points to x2's, at a
    fixed eps, at most ``iters`` iterations, stopping once every point is
    assigned (an iteration with no bidder changes nothing)."""
    return torch.cat([_auction(x1[i:i + rows], x2[i:i + rows], eps, iters, ops)
                      for i in range(0, x1.shape[0], rows)])


def _auction(x1, x2, eps, iters, ops):
    b, n, _ = x1.shape
    value = 3.0 - torch.sqrt(pairwise(x1, x2, ops))
    cols = torch.arange(n, device=x1.device)
    price = torch.zeros((b, n), device=x1.device)
    ass = torch.full((b, n), -1, dtype=torch.int64, device=x1.device)
    # Elements are independent: one whose points are all assigned makes no
    # more bids, so the loop drops it (its assignment final) once an eighth
    # of the elements still in the loop have finished.
    out, live = ass.clone(), torch.arange(b, device=x1.device)
    for it in range(iters):
        unass = ass < 0
        busy = unass.any(dim=1)
        left = int(busy.sum())
        if left == 0:
            break
        if 8 * (len(live) - left) >= len(live):
            out[live[~busy]] = ass[~busy]
            value, price, ass, unass, live = (t[busy] for t in (value, price, ass, unass, live))
        bids = value - price[:, None, :]
        best, best_col = torch.max(bids, dim=2)
        second = bids.scatter(2, best_col[..., None], _NEG).amax(dim=2)
        inc = (best - second) + eps
        onehot = (cols == best_col[..., None]) & unass[..., None]  # (B, row, col)
        winner_inc, winner_row = torch.max(
            torch.where(onehot, inc[..., None], torch.full_like(value, _NEG)), dim=1)
        won = onehot.any(dim=1)
        if it == iters - 1:  # the last iteration commits every bidder
            ass = torch.where(unass, best_col, ass)
            break
        commit = unass & (winner_row.gather(1, best_col) == cols)
        evicted = (ass >= 0) & won.gather(1, ass.clamp_min(0))
        price = price + torch.where(won, winner_inc, torch.zeros_like(price))
        ass = torch.where(commit, best_col, torch.where(evicted, -1, ass))
    out[live] = ass
    return out


def matched(x1: torch.Tensor, x2: torch.Tensor, ass: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances of x1's points to their assigned points,
    differentiable in x1."""
    return sqnorm(x1 - x2.gather(1, ass[..., None].expand(-1, -1, 3)))


def eps_schedule(eps: float, iters: int, eps0: float):
    """Each Sinkhorn iteration's eps: from eps0 down to eps geometrically
    over the first two thirds of the iterations, then eps."""
    q = (eps / eps0) ** (1.0 / max(1, (2 * iters) // 3))
    return [max(eps, eps0 * q ** t) for t in range(iters)]


@torch.no_grad()
def potentials(x: torch.Tensor, y: torch.Tensor, eps: float, iters: int, eps0: float,
               ops: Operands = FLOAT32):
    """The annealed Sinkhorn potentials (f (B, N), g (B, M)) between
    uniform measures on x and y under squared distance, Gauss-Seidel from
    zero."""
    c = pairwise(x, y, ops)
    log_mu, log_nu = -math.log(x.shape[1]), -math.log(y.shape[1])
    f = torch.zeros(x.shape[:2], device=x.device)
    g = torch.zeros(y.shape[:2], device=x.device)
    for e in eps_schedule(eps, iters, eps0):
        f = -e * torch.logsumexp((g[:, None, :] - c) / e + log_nu, dim=2)
        g = -e * torch.logsumexp((f[:, :, None] - c) / e + log_mu, dim=1)
    return f, g


def sinkhorn_loss_sum(pred: torch.Tensor, gt: torch.Tensor, blur: float, iters: int,
                      eps0: float = 0.25, ops: Operands = FLOAT32) -> torch.Tensor:
    """Sum over the batch of mean_i sqrt(N * sum_j pi_ij c_ij), the plan pi
    from detached potentials and a detached cost, the gradient through the
    live cost c."""
    eps = blur * blur
    eps0 = max(eps0, eps)
    n, m = pred.shape[1], gt.shape[1]
    c = pairwise(pred, gt, ops)
    f, g = potentials(pred.detach(), gt, eps, iters, eps0, ops)
    pi = torch.exp((f[:, :, None] + g[:, None, :] - c.detach()) / eps - math.log(n) - math.log(m))
    per_point = n * torch.sum(pi * c, dim=2)
    return torch.sqrt(per_point.clamp_min(0.0)).mean(dim=1).sum()
