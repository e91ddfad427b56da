"""Sinkhorn-divergence EMD alternate (counterpart of
``fenet/losses/sinkhorn.py``): entropic OT between uniform point-cloud
measures with log-domain Sinkhorn iterations.

``sinkhorn_emd_loss`` is the ``--emd_impl sinkhorn`` training loss: the
auction EMD's semantics (mean over points of the square root of the matched
squared distance) with the hard assignment replaced by the Sinkhorn plan,
whose potentials come from the kernel of :mod:`fenet_torch.ops.sinkhorn`.
``sinkhorn_distance`` and ``batch_emd_loss`` are the plain, fully
differentiable fixed-eps form.
"""

from __future__ import annotations

import math

import torch

from fenet_torch.ops.pairwise import pairwise_sqdist
from fenet_torch.ops.sinkhorn import sinkhorn_potentials


def sinkhorn_distance(x: torch.Tensor, y: torch.Tensor, blur: float = 0.01,
                      iters: int = 50) -> torch.Tensor:
    """Batched entropic OT cost OT_eps(x, y); x (B, N, 3), y (B, M, 3) ->
    (B,), squared-euclidean ground cost, eps = blur² (geomloss's p=2
    convention). Differentiable through the iterations."""
    n, m = x.shape[1], y.shape[1]
    eps = blur * blur
    c = pairwise_sqdist(x, y)
    log_mu, log_nu = -math.log(n), -math.log(m)
    f = c.new_zeros(x.shape[:2])
    g = c.new_zeros(y.shape[:2])
    for _ in range(iters):
        f = -eps * torch.logsumexp((g[:, None, :] - c) / eps + log_nu, dim=2)
        g = -eps * torch.logsumexp((f[:, :, None] - c) / eps + log_mu, dim=1)
    pi_log = (f[:, :, None] + g[:, None, :] - c) / eps + (log_mu + log_nu)
    return torch.sum(torch.exp(pi_log) * c, dim=(1, 2))


def batch_emd_loss(x: torch.Tensor, y: torch.Tensor, blur: float = 0.01,
                   iters: int = 50) -> torch.Tensor:
    """Mean Sinkhorn cost over the batch."""
    return sinkhorn_distance(x, y, blur, iters).mean()


def sinkhorn_emd_loss(pred: torch.Tensor, gt: torch.Tensor, blur: float = 0.01,
                      iters: int = 300, eps0: float = 0.25) -> torch.Tensor:
    """Auction-compatible training EMD via entropic OT.

    Per-point cost ``cost_i = N·sum_j pi_ij·C_ij`` (rows of pi sum to 1/N)
    with eps annealed from ``eps0`` down to ``blur²`` over 2/3 of the
    budget; the loss is the batch mean of ``mean_i sqrt(max(cost_i, 0))``.

    Gradient: the detached-plan rule, the same as the auction backward's
    fixed assignment: the plan is built from detached potentials and a
    detached cost, and the gradient flows only through the live cost
    matrix ``pairwise_sqdist(pred, gt)``.
    """
    n, m = pred.shape[1], gt.shape[1]
    eps = blur * blur
    # The anneal must start at or above the target, or eps would grow past
    # it and the plan below would be exponentiated at the wrong eps.
    eps0 = max(eps0, eps)
    c = pairwise_sqdist(pred, gt)  # live: the only gradient path
    c0 = c.detach()
    f, g = sinkhorn_potentials(pred, gt, eps, iters, eps0)  # detached
    pi = torch.exp((f[:, :, None] + g[:, None, :] - c0) / eps - math.log(n) - math.log(m))
    per_point = n * torch.sum(pi * c, dim=2)  # (B, N)
    return torch.sqrt(per_point.clamp_min(0.0)).mean(dim=1).mean()
