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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
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
