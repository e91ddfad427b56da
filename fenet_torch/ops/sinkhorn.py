"""Annealed log-domain Sinkhorn potentials: hand-written CUDA kernel + plain
PyTorch version (counterpart of ``fenet/ops/sinkhorn.py``, both its resident
and its streaming Pallas kernels).

``sinkhorn_potentials(x, y, eps, iters, eps0) -> (f, g)``: the potentials of
entropic OT between uniform measures on x (B, N, 3) and y (B, M, 3) under
squared-euclidean cost, (B, N) and (B, M). From f = g = 0, iteration t with
``e = max(eps, eps0·exp(log_q·t))`` updates, Gauss-Seidel,

    f_i = -e·LSE_j[(g_j - C_ij)/e - log M]
    g_j = -e·LSE_i[(f_i - C_ij)/e - log N]

where ``q = (eps/eps0)^(1/max(1, 2·iters//3))``, so eps anneals from eps0 to
eps at 2/3 of the budget. The potentials are used detached (the loss's
detached-plan gradient rule), so the op has no gradient.

For CPU tensors the wrapper runs the plain version :func:`_potentials_plain`;
for CUDA tensors it launches ``csrc/sinkhorn.cu`` (:func:`potentials_kernel`)
or raises. Above ``MAX_N`` points, where fenet's Pallas kernels decline and
fenet runs its XLA loop, the wrapper runs the plain version on the tensors'
own device. The choice is by shape alone, before any launch; the kernel
wrapper itself raises above ``MAX_N``. The kernel keeps the plain version's bits of every exponent
``(pot_j - C_ij)/e + log_w`` (the quotient from a per-iteration reciprocal
and two FMAs) and sums ``ex2.approx`` of them over tiles of columns with a
running max, so it agrees with the plain version to fenet's tolerance (rtol
1e-4, atol 1e-5), not bit for bit.

``plan_cost(x, y, f, g, eps) -> (B, N)``: the Sinkhorn EMD loss's per-point
cost ``N·sum_j pi_ij·c_ij`` from the potentials, pi detached and c =
``pairwise_sqdist(x, y)`` live, differentiable in x and y, on CUDA tensors
(``csrc/sinkhorn_plan.cu``: :func:`plan_kernel`, and
:func:`plan_columns_kernel` for y's gradient). Its plain version is
``fenet_torch.losses.sinkhorn.plan_loss`` over ``pairwise_sqdist``, which
the loss runs for CPU tensors; the op itself launches or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fenet_torch.ops import _build
from fenet_torch.ops.pairwise import pairwise_sqdist
from fenet_torch.utils.profiling import span

# Points per cloud the kernel takes: x or y with their potential staged in
# shared memory at 20 bytes a point (160 KB at 8192).
MAX_N = 8192


def eps_schedule(eps: float, iters: int, eps0: float) -> torch.Tensor:
    """(iters,) float32 CPU tensor: each iteration's eps, computed in float32
    as the Pallas body computes it (``fenet/ops/sinkhorn.py:80-89``)."""
    q = (eps / eps0) ** (1.0 / max(1, (2 * iters) // 3))
    log_q = torch.tensor(math.log(q), dtype=torch.float32)
    t = torch.arange(iters, dtype=torch.float32)
    return torch.maximum(torch.tensor(eps, dtype=torch.float32),
                         torch.tensor(eps0, dtype=torch.float32) * torch.exp(log_q * t))


@functools.lru_cache(maxsize=16)
def _device_schedule(eps: float, iters: int, eps0: float, device: torch.device) -> torch.Tensor:
    """:func:`eps_schedule` on ``device``, copied there once per setting: a
    blocking copy in every training step would stall the host mid-step."""
    return eps_schedule(eps, iters, eps0).to(device)


def _potentials_plain(x: torch.Tensor, y: torch.Tensor, eps: float, iters: int,
                      eps0: float):
    """Plain version of the kernel, the Pallas body's arithmetic over the
    dense (B, N, M) cost matrix."""
    n, m = x.shape[1], y.shape[1]
    c = pairwise_sqdist(x, y)
    log_mu, log_nu = -math.log(n), -math.log(m)
    f = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    g = torch.zeros(y.shape[:2], dtype=torch.float32, device=x.device)
    for e in eps_schedule(eps, iters, eps0).tolist():
        z = (g[:, None, :] - c) / e + log_nu
        zmax = z.amax(dim=2, keepdim=True)
        f = (-e * (torch.log(torch.exp(z - zmax).sum(dim=2, keepdim=True)) + zmax))[..., 0]
        w = (f[:, :, None] - c) / e + log_mu
        wmax = w.amax(dim=1, keepdim=True)
        g = (-e * (torch.log(torch.exp(w - wmax).sum(dim=1, keepdim=True)) + wmax))[:, 0]
    return f, g


def potentials_kernel(x: torch.Tensor, y: torch.Tensor, eps: float, iters: int,
                      eps0: float):
    """Launch the CUDA kernel (replaces ``fenet/ops/sinkhorn.py``'s
    ``_sinkhorn_kernel`` and ``_sinkhorn_stream_kernel``).

    x (B,N,3), y (B,M,3) float32, contiguous, on one CUDA device, N, M <=
    8192 -> f (B,N), g (B,M) float32. Counts its launches in
    ``potentials_kernel.launches``.
    """
    _build.check_clouds(x, y, "sinkhorn")
    bsz, n, m = x.shape[0], x.shape[1], y.shape[1]
    if n > MAX_N or m > MAX_N:
        raise ValueError(f"sinkhorn: clouds of {n} and {m} points, needs N, M <= {MAX_N}")
    if iters < 1:
        raise ValueError(f"sinkhorn: needs iters >= 1, got {iters}")
    table = _device_schedule(eps, iters, eps0, x.device)
    f = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    g = torch.empty((bsz, m), dtype=torch.float32, device=x.device)
    fn = _build.library("sinkhorn").fenet_sinkhorn
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), y.data_ptr(), table.data_ptr(), f.data_ptr(),
                    g.data_ptr(), bsz, n, m, iters, -math.log(n), -math.log(m),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "sinkhorn")
    potentials_kernel.launches += 1
    return f, g


potentials_kernel.launches = 0


@torch.no_grad()
def sinkhorn_potentials(x: torch.Tensor, y: torch.Tensor, eps: float,
                        iters: int, eps0: float = 0.25):
    """Annealed Sinkhorn potentials (f, g) for uniform point-cloud marginals
    under squared-euclidean cost; x (B, N, 3), y (B, M, 3) -> (B, N), (B, M).

    ``eps0`` is raised to ``eps`` if below it, so the anneal never grows.
    Above ``MAX_N`` points the plain version runs on the tensors' device
    (dense (B, N, M) arrays, as fenet's XLA loop holds them).
    """
    eps0 = max(eps0, eps)
    with span("fenet_torch.ops.potentials"):
        x = x.detach().float().contiguous()
        y = y.detach().float().contiguous()
        on_cpu = x.device.type == "cpu" and y.device.type == "cpu"
        if on_cpu or max(x.shape[1], y.shape[1]) > MAX_N:
            return _potentials_plain(x, y, eps, iters, eps0)
        return potentials_kernel(x, y, eps, iters, eps0)


def _plan_launch(symbol: str, kernel: str, tensors, f, g, eps: float) -> None:
    """Check the plan kernels' inputs (``tensors`` starts with x, y, then
    f, g and the kernel's other tensors, outputs last) and launch ``symbol``
    of ``csrc/sinkhorn_plan.cu`` on the current stream."""
    x, y = tensors[0], tensors[1]
    _build.check_clouds(x, y, kernel)
    for name, pot, pts in (("f", f, x), ("g", g, y)):
        if (pot.dtype != torch.float32 or pot.shape != pts.shape[:2]
                or pot.device != pts.device or not pot.is_contiguous()):
            raise ValueError(f"{kernel}: {name} is {pot.dtype} {tuple(pot.shape)} on "
                             f"{pot.device}, needs contiguous float32 {tuple(pts.shape[:2])} "
                             f"on {pts.device}")
    n, m = x.shape[1], y.shape[1]
    fn = getattr(_build.library("sinkhorn_plan"), symbol)
    with torch.cuda.device(x.device):
        status = fn(*(t.data_ptr() for t in tensors), x.shape[0], n, m, ctypes.c_float(eps),
                    ctypes.c_float(math.log(n)), ctypes.c_float(math.log(m)),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, kernel)


def plan_kernel(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                eps: float):
    """Launch the plan's row pass (``csrc/sinkhorn_plan.cu``; replaces no
    Pallas kernel: fenet's plan is XLA, ``fenet/losses/sinkhorn.py:104-109``).

    x (B,N,3), y (B,M,3), f (B,N), g (B,M) float32, contiguous, on one CUDA
    device, eps > 0 -> the per-point cost (B,N) ``N·sum_j pi_ij·c_ij`` and V
    (B,N,3) ``sum_j pi_ij·[d_ij >= 0]·(x_i - y_j)``, d the unclamped cost.
    Counts its launches in ``plan_kernel.launches``.
    """
    cost = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    v = torch.empty_like(x)
    _plan_launch("fenet_sinkhorn_plan_rows", "sinkhorn_plan", (x, y, f, g, cost, v), f, g, eps)
    plan_kernel.launches += 1
    return cost, v


plan_kernel.launches = 0


def plan_columns_kernel(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                        u: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the plan's column pass, for y's gradient: the inputs of
    :func:`plan_kernel` and u (B,N), the upstream gradient of the per-point
    cost -> W (B,M,3) ``sum_i u_i·pi_ij·[d_ij >= 0]·(x_i - y_j)``. Counts
    its launches in ``plan_columns_kernel.launches``."""
    if u.dtype != torch.float32 or u.shape != f.shape or u.device != x.device:
        raise ValueError(f"sinkhorn_plan_columns: u is {u.dtype} {tuple(u.shape)} on "
                         f"{u.device}, needs float32 {tuple(f.shape)} on {x.device}")
    out = torch.empty_like(y)
    _plan_launch("fenet_sinkhorn_plan_cols", "sinkhorn_plan_columns",
                 (x, y, f, g, u.contiguous(), out), f, g, eps)
    plan_columns_kernel.launches += 1
    return out


plan_columns_kernel.launches = 0


class _PlanCost(torch.autograd.Function):
    """The per-point cost with the detached-plan gradient: c's gradient is
    ``N·u_i·pi_ij`` where the unclamped cost is >= 0 (autograd's clamp_min
    rule), so x_i's is ``2N·u_i·V_i`` and y_j's ``-2N·W_j``."""

    @staticmethod
    def forward(ctx, x, y, f, g, eps):
        cost, v = plan_kernel(x, y, f, g, eps)
        ctx.save_for_backward(x, y, f, g, v)
        ctx.eps = eps
        return cost

    @staticmethod
    def backward(ctx, grad):
        x, y, f, g, v = ctx.saved_tensors
        scale = 2.0 * x.shape[1]
        grad_x = grad_y = None
        if ctx.needs_input_grad[0]:
            grad_x = (grad * scale)[..., None] * v
        if ctx.needs_input_grad[1]:
            grad_y = plan_columns_kernel(x, y, f, g, grad, ctx.eps) * -scale
        return grad_x, grad_y, None, None, None


def plan_cost(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
              eps: float) -> torch.Tensor:
    """The Sinkhorn EMD loss's per-point cost (B, N), ``N·sum_j pi_ij·c_ij``
    with ``pi = exp((f_i + g_j - c_ij)/eps - log N - log M)`` detached and
    c = ``pairwise_sqdist(x, y)``, on CUDA tensors; differentiable in x (and
    y, by a second kernel launched only when y needs its gradient). No
    tensor of N·M elements is made."""
    return _PlanCost.apply(x.contiguous(), y.contiguous(), f.detach().contiguous(),
                           g.detach().contiguous(), eps)
