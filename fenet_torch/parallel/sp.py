"""Point-axis parallelism: the ring-sharded chamfer distance (counterpart
of ``fenet/parallel/sp.py``).

Each of the D ranks of a group holds an N/D block of cloud A and an M/D
block of cloud B (:func:`shard_points`). B's blocks rotate around the ring
(point-to-point send to the next rank, receive from the previous), and at
each of the D hops every rank takes the nearest neighbour of its A points
in the block it holds with :func:`fenet_torch.ops.chamfer.nearest_neighbour`
(K1, ``csrc/chamfer_nn.cu``, on the card) and keeps a running (distance,
global index, matched point). No rank ever holds the (N, M) distances or
the whole opposite cloud. The same ring runs with the clouds' roles
swapped, so a forward launches K1 2·D times on each rank.

The merge keeps the strictly smaller distance, or the equal one with the
lower global index (offset ``owner · m_loc``): the first-minimum rule of a
full-axis argmin, so the distances and indices are the one-process
``chamfer_distance``'s bit for bit, in any rotation order.

The backward mirrors the dense op's (``fenet_torch/ops/chamfer.py``): the
local halves ``2 g (x − matched)``, and the cross halves scattered into the
opposite cloud by an accumulator block per owner that visits every rank
and comes home after D hops, summed in a fixed order (ring position) with
the dense op's deterministic scatter. The addition order differs from the
dense op's, so the gradients agree to rounding (exactly on inputs whose
sums are exact).

Under gloo a CUDA block is staged through a host buffer at each hop
(:func:`fenet_torch.parallel.mesh.transport`); NCCL moves it card to card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from fenet_torch.ops.chamfer import nearest_neighbour, scatter_rows
from fenet_torch.parallel.mesh import transport


def _group_size_rank(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def shard_points(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of the point axis (dim 1) of a (B, N, ...) tensor;
    N must divide by the group's size."""
    d, me = _group_size_rank(group)
    if x.shape[1] % d:
        raise ValueError(f"{x.shape[1]} points do not split over {d} ranks")
    return x.chunk(d, dim=1)[me].contiguous()


def _shift(block: torch.Tensor, group) -> torch.Tensor:
    """Send ``block`` to the next rank of the ring and receive the previous
    rank's (same shape)."""
    d, me = _group_size_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % d) if group is not None else (me + 1) % d
    prv = dist.get_global_rank(group, (me - 1) % d) if group is not None else (me - 1) % d
    staged = transport(group, block.device) == "host"
    send = block.cpu() if staged else block.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(block.device) if staged else recv


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx.long()[..., None].expand(-1, -1, 3))


def _ring_nn(a: torch.Tensor, b: torch.Tensor, group):
    """The running nearest neighbour of each local A point over every B
    block: (B, n) distances, (B, n) int32 global indices, (B, n, 3)
    matched points."""
    d, me = _group_size_rank(group)
    m = b.shape[1]
    block = b
    for t in range(d):
        owner = (me - t) % d
        dist_t, local = nearest_neighbour(a, block)
        index = local + owner * m
        matched = _gather_rows(block, local)
        if t == 0:
            best_d, best_i, best_m = dist_t, index, matched
        else:
            better = (dist_t < best_d) | ((dist_t == best_d) & (index < best_i))
            best_d = torch.where(better, dist_t, best_d)
            best_i = torch.where(better, index, best_i)
            best_m = torch.where(better[..., None], matched, best_m)
        if t < d - 1:
            block = _shift(block, group)
    return best_d, best_i, best_m


def _ring_scatter(contrib: torch.Tensor, idx: torch.Tensor, m: int, group) -> torch.Tensor:
    """Sum ``contrib`` (B, n, 3) into the opposite cloud's rows at the
    global indices ``idx`` (B, n); returns this rank's (B, m, 3) block. The
    accumulator of owner o starts on o and gathers the ranks' terms in ring
    order o, o+1, ..., o+D-1 before it comes home."""
    d, me = _group_size_rank(group)
    acc = contrib.new_zeros((contrib.shape[0], m, 3))
    for t in range(d):
        owner = (me - t) % d
        local = idx.long() - owner * m
        inside = (local >= 0) & (local < m)
        vals = torch.where(inside[..., None], contrib, torch.zeros_like(contrib))
        acc = acc + scatter_rows(local.clamp(0, m - 1), vals, m)
        acc = _shift(acc, group)
    return acc


class _RingChamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, group):
        d1, i1, m1 = _ring_nn(x1, x2, group)
        d2, i2, m2 = _ring_nn(x2, x1, group)
        ctx.group = group
        ctx.mark_non_differentiable(i1, i2)
        ctx.save_for_backward(x1, x2, i1, i2, m1, m2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x1, x2, i1, i2, m1, m2 = ctx.saved_tensors
        grad1 = 2.0 * g1[..., None] * (x1 - m1)
        grad2 = 2.0 * g2[..., None] * (x2 - m2)
        dx1 = grad1 + _ring_scatter(-grad2, i2, x1.shape[1], ctx.group)
        dx2 = grad2 + _ring_scatter(-grad1, i1, x2.shape[1], ctx.group)
        return dx1, dx2, None


def make_sharded_chamfer(group=None):
    """``chamfer(x1, x2) -> (d1, d2, i1, i2)`` over the point axis of
    ``group``'s ranks (default: all of them).

    Each rank passes its blocks, x1 (B, N/D, 3) and x2 (B, M/D, 3) (see
    :func:`shard_points`), and gets its blocks of the one-process
    ``chamfer_distance``'s outputs: squared distances (B, N/D) and (B, M/D),
    int32 global indices into the other cloud, with gradients to both
    blocks. Every rank calls it together (it is a ring of collectives).
    """

    def chamfer(x1: torch.Tensor, x2: torch.Tensor):
        return _RingChamfer.apply(x1.float().contiguous(), x2.float().contiguous(), group)

    return chamfer
