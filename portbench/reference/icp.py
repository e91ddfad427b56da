"""Batched ICP of the eval path in plain PyTorch: nearest-neighbour
correspondence, Horn's quaternion best fit (the dominant eigenvector by
repeated normalised squaring), plateau, period-2 and stall stops per
element, best-so-far tracking; the prediction is pulled onto the gt by the
transform fitted from gt to prediction."""

from __future__ import annotations

import torch

from portbench.reference.losses import nearest
from portbench.reference.precision import FLOAT32, Operands


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def best_fit(a: torch.Tensor, b: torch.Tensor, ops: Operands = FLOAT32):
    """The proper rotation R (B, 3, 3) and translation t (B, 3) that map the
    points a (B, N, 3) onto their partners b in least squares."""
    ca, cb = a.mean(dim=1), b.mean(dim=1)
    h = torch.einsum("bni,bnj->bij", ops(a - ca[:, None]), ops(b - cb[:, None]))
    sxx, sxy, sxz = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    syx, syy, syz = h[:, 1, 0], h[:, 1, 1], h[:, 1, 2]
    szx, szy, szz = h[:, 2, 0], h[:, 2, 1], h[:, 2, 2]
    k = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], dim=1)
    shift = k.abs().sum(dim=2).amax(dim=1) + 1e-6
    k = k + shift[:, None, None] * torch.eye(4, dtype=k.dtype, device=k.device)
    for _ in range(16):
        k = (k[:, :, :, None] * k[:, None, :, :]).sum(dim=2)
        k = k / (torch.sqrt((k * k).sum(dim=(1, 2), keepdim=True)) + 1e-30)
    v0 = torch.full((a.shape[0], 4), 0.5, dtype=k.dtype, device=k.device)
    q = torch.einsum("bij,bj->bi", k, v0)
    q = q / (torch.linalg.norm(q, dim=1, keepdim=True) + 1e-20)
    r = _quat_to_rotmat(q)
    return r, cb - torch.einsum("bij,bj->bi", r, ca)


def _loop(b: torch.Tensor, src: torch.Tensor, max_iterations: int, tolerance: float,
          rel_tolerance: float, patience: int, ops: Operands) -> torch.Tensor:
    bsz, dev = src.shape[0], src.device
    best_src = src
    err1 = torch.zeros(bsz, device=dev)
    err2 = torch.full((bsz,), -1.0, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    best_err = torch.full((bsz,), float("inf"), device=dev)
    stall = torch.zeros(bsz, dtype=torch.int32, device=dev)
    stall_ref = torch.full((bsz,), float("inf"), device=dev)
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        d, idx = nearest(src, b, ops)
        dist = torch.sqrt(d)
        partner = torch.gather(b, 1, idx[..., None].expand(-1, -1, 3))
        r, t = best_fit(src, partner, ops)
        new_src = torch.einsum("bni,bji->bnj", ops(src), ops(r)) + t[:, None, :]
        err = dist.mean(dim=1)
        thr = torch.clamp_min(rel_tolerance * (err + 0.01), tolerance)
        newly_done = ((err1 - err).abs() < thr) | ((err2 - err).abs() < thr)
        improved = (~done) & (err < best_err)
        best_err = torch.where(improved, err, best_err)
        best_src = torch.where(improved[:, None, None], src, best_src)
        if patience > 0:
            progressed = (~done) & (stall_ref - err > thr)
            stall = torch.where(progressed, 0, stall + 1)
            stall_ref = torch.where(progressed, err, stall_ref)
            newly_done = newly_done | (stall >= patience)
        src = torch.where(done[:, None, None], src, new_src)
        err2 = torch.where(done, err2, err1)
        err1 = torch.where(done, err1, err)
        done = done | newly_done
    return best_src


@torch.no_grad()
def align(pred: torch.Tensor, gt: torch.Tensor, max_iterations: int = 1024,
          tolerance: float = 1e-10, rel_tolerance: float = 1e-6, patience: int = 32,
          ops: Operands = FLOAT32) -> torch.Tensor:
    """pred (B, N, 3) pulled onto gt: ICP from gt to pred fits R, t, and the
    result is pred @ R - t."""
    src = _loop(pred, gt, max_iterations, tolerance, rel_tolerance, patience, ops)
    r, t = best_fit(gt, src, ops)
    return torch.einsum("bnj,bjk->bnk", ops(pred), ops(r)) - t[:, None, :]
