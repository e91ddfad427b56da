"""Sinkhorn-divergence EMD alternate (counterpart of
``fenet/losses/sinkhorn.py``): entropic OT between uniform point-cloud
measures with log-domain Sinkhorn iterations.

``sinkhorn_emd_loss`` is the ``--emd_impl sinkhorn`` training loss: the
auction EMD's semantics (mean over points of the square root of the matched
squared distance) with the hard assignment replaced by the Sinkhorn plan,
whose potentials come from the kernel of :mod:`fenet_torch.ops.sinkhorn`.
On CUDA tensors its plan runs in that module's fused kernel
(:func:`~fenet_torch.ops.sinkhorn.plan_cost`), on CPU tensors in
:func:`plan_loss`, its plain version. ``sinkhorn_distance`` and
``batch_emd_loss`` are the plain, fully differentiable fixed-eps form.
"""

from __future__ import annotations

import math

import torch

from fenet_torch.ops.pairwise import pairwise_sqdist
from fenet_torch.ops.sinkhorn import plan_cost, sinkhorn_potentials
from fenet_torch.utils.profiling import span


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


def plan_loss(c0: torch.Tensor, c: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
              eps: float) -> torch.Tensor:
    """The training loss from a pair of potentials f (B, N), g (B, M): the
    plan ``pi = exp((f_i + g_j - c0_ij)/eps) / (N·M)`` from the detached cost
    c0, the per-point cost ``N·sum_j pi_ij·c_ij`` through the cost c (B, N,
    M), and the batch mean of ``mean_i sqrt(max(cost_i, 0))``."""
    n, m = c.shape[1], c.shape[2]
    pi = torch.exp((f[:, :, None] + g[:, None, :] - c0) / eps - math.log(n) - math.log(m))
    return mean_root(n * torch.sum(pi * c, dim=2))


def mean_root(per_point: torch.Tensor) -> torch.Tensor:
    """The batch mean of ``mean_i sqrt(max(cost_i, 0))`` of the per-point
    costs (B, N)."""
    return torch.sqrt(per_point.clamp_min(0.0)).mean(dim=1).mean()


def sinkhorn_emd_loss(pred: torch.Tensor, gt: torch.Tensor, blur: float = 0.01,
                      iters: int = 300, eps0: float = 0.25) -> torch.Tensor:
    """Auction-compatible training EMD via entropic OT.

    Per-point cost ``cost_i = N·sum_j pi_ij·C_ij`` (rows of pi sum to 1/N)
    with eps annealed from ``eps0`` down to ``blur²`` over 2/3 of the
    budget; the loss is the batch mean of ``mean_i sqrt(max(cost_i, 0))``.

    Gradient: the detached-plan rule, the same as the auction backward's
    fixed assignment: the plan is built from detached potentials and a
    detached cost, and the gradient flows only through the live cost
    matrix ``pairwise_sqdist(pred, gt)``. On CUDA tensors the fused plan
    computes the same, pair by pair, without the (B, N, M) tensors.
    """
    eps = blur * blur
    # The anneal must start at or above the target, or eps would grow past
    # it and the plan would be exponentiated at the wrong eps.
    eps0 = max(eps0, eps)
    # A lookup of the module's global, and the plan after it returns:
    # portbench's traced runs time the potentials by wrapping this name.
    f, g = sinkhorn_potentials(pred, gt, eps, iters, eps0)  # detached
    with span("fenet_torch.sinkhorn.plan"):
        if pred.device.type == "cpu" and gt.device.type == "cpu":
            c = pairwise_sqdist(pred, gt)  # live: the only gradient path
            return plan_loss(c.detach(), c, f, g, eps)
        return mean_root(plan_cost(pred, gt, f, g, eps))
