"""ICP in plain PyTorch (counterpart of ``fenet/geometry/icp.py``): the
single-pair solver with its SVD best fit (the reference's utils/icp.py), and
the natively batched solver of the eval path.

Correspondence is a brute-force argmin over the pairwise distance matrix;
the best-fit rotation is Horn's quaternion method with the dominant
eigenvector found by repeated normalised squaring of a 4x4 matrix. The
JAX package leaves this to XLA, so the port keeps it as plain tensor code.
``_icp_loop``'s ``while_loop`` is a Python loop that ends when every batch
element is done: one host sync per iteration.
"""

from __future__ import annotations

import torch

from fenet_torch.ops.pairwise import pairwise_sqdist


def best_fit_transform(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares rigid transform mapping corresponding points a -> b,
    (N, 3) each: the 4x4 homogeneous T from the SVD of the covariance, with
    the reference's reflection fix (the last row of Vt negated where
    det(R) < 0)."""
    ca, cb = a.mean(dim=0), b.mean(dim=0)
    h = (a - ca).T @ (b - cb)
    u, _, vt = torch.linalg.svd(h)
    r = vt.T @ u.T
    flip = torch.ones(3, dtype=a.dtype, device=a.device)
    flip[-1] = -1.0
    r = torch.where(torch.linalg.det(r) < 0, (vt * flip[:, None]).T @ u.T, r)
    out = torch.eye(4, dtype=a.dtype, device=a.device)
    out[:3, :3] = r
    out[:3, 3] = cb - r @ ca
    return out


def icp(a: torch.Tensor, b: torch.Tensor, max_iterations: int = 20,
        tolerance: float = 0.001):
    """Single-pair ICP, a and b (N, 3): ``(T 4x4 mapping a onto b, the final
    nearest-neighbour distances (N,), iterations run)``. Stops when the
    mean distance changes by less than ``tolerance``; T is refit from ``a``
    to the converged source, as the reference does (icp.py:100-117)."""
    src, prev_err, it = a, torch.zeros((), dtype=a.dtype, device=a.device), 0
    while it < max_iterations:
        dist, idx = _nn_batched(src[None], b[None])
        t = best_fit_transform(src, b[idx[0]])
        src = src @ t[:3, :3].T + t[:3, 3]
        err = dist.mean()
        it += 1
        if bool((prev_err - err).abs() < tolerance):
            break
        prev_err = err
    dist, _ = _nn_batched(src[None], b[None])
    return best_fit_transform(a, src), dist[0], it


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) unit quaternions (w, x, y, z) -> (B, 3, 3) rotations."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=1,
    )


def best_fit_rotation_batched(a: torch.Tensor, b: torch.Tensor):
    """Least-squares proper rotation + translation mapping a -> b.

    a, b: (B, N, 3) corresponding points. Returns (R (B,3,3), t (B,3)).
    """
    ca = a.mean(dim=1)
    cb = b.mean(dim=1)
    h = torch.einsum("bni,bnj->bij", a - ca[:, None], b - cb[:, None])
    sxx, sxy, sxz = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    syx, syy, syz = h[:, 1, 0], h[:, 1, 1], h[:, 1, 2]
    szx, szy, szz = h[:, 2, 0], h[:, 2, 1], h[:, 2, 2]
    k = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
        ],
        dim=1,
    )  # (B, 4, 4), symmetric; dominant eigenvector = optimal quaternion
    # Shift by a Gershgorin bound so the dominant eigenvalue is the largest
    # in magnitude, then take K^(2^16) by 16 normalised squarings: repeated
    # squaring amplifies even tiny eigengaps.
    shift = k.abs().sum(dim=2).amax(dim=1) + 1e-6
    k = k + shift[:, None, None] * torch.eye(4, dtype=k.dtype, device=k.device)
    for _ in range(16):
        k = (k[:, :, :, None] * k[:, None, :, :]).sum(dim=2)
        k = k / (torch.sqrt((k * k).sum(dim=(1, 2), keepdim=True)) + 1e-30)
    v0 = torch.full((a.shape[0], 4), 0.5, dtype=k.dtype, device=k.device)
    q = torch.einsum("bij,bj->bi", k, v0)
    q = q / (torch.linalg.norm(q, dim=1, keepdim=True) + 1e-20)
    r = _quat_to_rotmat(q)
    t = cb - torch.einsum("bij,bj->bi", r, ca)
    return r, t


def _nn_batched(src: torch.Tensor, dst: torch.Tensor):
    """Batched NN: (B, N, 3) into (B, M, 3) -> (sqrt dists (B,N), idx (B,N))."""
    d, idx = torch.min(pairwise_sqdist(src, dst), dim=-1)
    return torch.sqrt(d), idx


def _icp_loop(a: torch.Tensor, b: torch.Tensor, src0: torch.Tensor,
              max_iterations: int, tolerance: float, rel_tolerance: float,
              stall_patience: int) -> torch.Tensor:
    """One ICP phase: iterate src0 toward b and return the best-so-far source
    positions (the caller re-fits a rigid transform from ``a`` to them)."""
    bsz, dev = a.shape[0], a.device
    src, best_src = src0, src0
    err1 = torch.zeros(bsz, device=dev)
    err2 = torch.full((bsz,), -1.0, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    best_err = torch.full((bsz,), float("inf"), device=dev)
    stall = torch.zeros(bsz, dtype=torch.int32, device=dev)
    stall_ref = torch.full((bsz,), float("inf"), device=dev)
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        dist, idx = _nn_batched(src, b)
        matched = torch.gather(b, 1, idx[..., None].expand(-1, -1, 3))
        r, t = best_fit_rotation_batched(src, matched)
        new_src = torch.einsum("bni,bji->bnj", src, r) + t[:, None, :]
        err = dist.mean(dim=1)
        # Plateau thresholds keep a small absolute floor (clouds are ~unit
        # scale): near-perfect alignment drives err to 0, where a purely
        # relative test would chase float32 noise.
        thr = torch.clamp_min(rel_tolerance * (err + 0.01), tolerance)
        # Period-2 test: an element bouncing between two equally good optima
        # stops; best-so-far tracking returns the better state.
        newly_done = ((err1 - err).abs() < thr) | ((err2 - err).abs() < thr)
        improved = (~done) & (err < best_err)
        best_err = torch.where(improved, err, best_err)
        best_src = torch.where(improved[:, None, None], src, best_src)
        if stall_patience > 0:
            # Reset the stall counter only when the error dropped by more
            # than the plateau threshold since the last reset, so drift at
            # the float32 floor still times out.
            progressed = (~done) & (stall_ref - err > thr)
            stall = torch.where(progressed, 0, stall + 1)
            stall_ref = torch.where(progressed, err, stall_ref)
            newly_done = newly_done | (stall >= stall_patience)
        src = torch.where(done[:, None, None], src, new_src)
        err2 = torch.where(done, err2, err1)
        err1 = torch.where(done, err1, err)
        done = done | newly_done
    return best_src


def batched_icp(a: torch.Tensor, b: torch.Tensor, max_iterations: int = 1024,
                tolerance: float = 1e-10, rel_tolerance: float = 1e-6,
                stall_patience: int = 32, coarse_points: int = 0,
                coarse_iterations: int = 512) -> torch.Tensor:
    """Batched ICP over (B, N, 3) pairs; returns T (B, 4, 4) mapping a onto b.

    Same convergence semantics per element as fenet's ``batched_icp``:
    absolute/relative plateau, period-2 detection, stall patience, and
    best-so-far tracking. ``coarse_points`` > 0 warm-starts from an ICP on
    stride-subsampled clouds of that size.
    """
    bsz = a.shape[0]
    src0 = a
    if 0 < coarse_points < min(a.shape[1], b.shape[1]):
        a_c = a[:, :: a.shape[1] // coarse_points][:, :coarse_points]
        b_c = b[:, :: b.shape[1] // coarse_points][:, :coarse_points]
        best_c = _icp_loop(a_c, b_c, a_c, coarse_iterations, tolerance,
                           rel_tolerance, stall_patience)
        r0, t0 = best_fit_rotation_batched(a_c, best_c)
        src0 = torch.einsum("bni,bji->bnj", a, r0) + t0[:, None, :]
    src = _icp_loop(a, b, src0, max_iterations, tolerance, rel_tolerance,
                    stall_patience)
    r, t = best_fit_rotation_batched(a, src)
    out = torch.zeros((bsz, 4, 4), dtype=a.dtype, device=a.device)
    out[:, :3, :3] = r
    out[:, :3, 3] = t
    out[:, 3, 3] = 1.0
    return out


def align_pred_to_gt(pred: torch.Tensor, gt: torch.Tensor,
                     max_iterations: int = 1024, tolerance: float = 1e-10,
                     rel_tolerance: float = 1e-6, stall_patience: int = 32,
                     coarse_points: int = 0,
                     coarse_iterations: int = 512) -> torch.Tensor:
    """The eval step's alignment: fit T = icp(gt, pred), then return
    ``pred @ R - t``, the prediction pulled onto the gt."""
    t = batched_icp(gt, pred, max_iterations=max_iterations,
                    tolerance=tolerance, rel_tolerance=rel_tolerance,
                    stall_patience=stall_patience, coarse_points=coarse_points,
                    coarse_iterations=coarse_iterations)
    return torch.einsum("bnj,bjk->bnk", pred, t[:, :3, :3]) - t[:, None, :3, 3]
