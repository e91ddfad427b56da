"""The (batch, model) process mesh and its collectives (counterpart of
``fenet/parallel/mesh.py``).

fenet shards one program over a device mesh with ``shard_map``. Here each
rank is a process: rank ``r`` sits at ``(r // tp, r % tp)`` of a
``dp × tp`` mesh. The ranks of one mesh column (one tensor-parallel index)
form the data-parallel group, over which gradients, losses and BatchNorm
statistics are averaged; the ranks of one row (one batch shard) form the
tensor-parallel group of the Megatron decoder split
(:mod:`fenet_torch.parallel.tp`).

Transport: NCCL takes CUDA tensors and gloo takes CPU tensors. A collective
here runs on the tensor where its group's backend takes it, and stages it
through the other device otherwise; that is chosen by the backend, never by
catching an error (:func:`transport`). So two ranks that share one card
run on gloo, with each collective copied through host memory.

Three differentiable collectives, whose backward each state:
:func:`all_reduce_sum` (sum forward, sum backward: sync-BN's statistics,
where every rank's loss depends on every rank's rows),
:func:`reduce_from_group` (sum forward, identity backward: the
row-parallel output, whose downstream loss every peer holds whole) and
:func:`copy_to_group` (identity forward, sum backward: the column-parallel
input, whose gradient from one shard is partial).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from fenet_torch.parallel.distributed import world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp × tp`` mesh of ranks and this rank's two groups (None where
    the axis has size 1; a one-process mesh has neither)."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    dp_group: Optional[dist.ProcessGroup] = None
    tp_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def world_group(self) -> Optional[dist.ProcessGroup]:
        """The default group where the mesh has more than one rank."""
        return dist.group.WORLD if self.size > 1 else None


LAUNCH_HINT = (
    "launch one process per rank: torchrun --nproc_per_node N -m "
    "fenet_torch.cli.train ..., or set COORDINATOR_ADDRESS=host:port, "
    "FENET_NUM_PROCESSES and FENET_PROCESS_ID in each process "
    "(FENET_DIST_BACKEND=gloo for ranks that share one card)")


def make_mesh(data_parallel: int = 1, model_parallel: int = 1) -> Mesh:
    """The mesh over every rank of the process group. ``data_parallel`` 1
    sizes the batch axis to ``world / model_parallel``, as fenet's driver
    does; otherwise ``data_parallel × model_parallel`` must be the world
    size. Every rank makes every group, in the same order."""
    world = world_size()
    tp = max(int(model_parallel), 1)
    if world % tp:
        raise ValueError(f"model_parallel {tp} does not divide the world of {world} "
                         f"processes; {LAUNCH_HINT}")
    dp = world // tp if data_parallel <= 1 else int(data_parallel)
    if dp * tp != world:
        raise ValueError(f"data_parallel × model_parallel = {dp} × {tp} needs {dp * tp} "
                         f"processes, this run has {world}; {LAUNCH_HINT}")
    if world == 1:
        return Mesh()
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)] \
        if dp > 1 else None
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)] \
        if tp > 1 else None
    rank = dist.get_rank()
    return Mesh(dp, tp, rank, dp_groups[rank % tp] if dp_groups else None,
                tp_groups[rank // tp] if tp_groups else None)


def transport(group=None, device: torch.device | None = None) -> str:
    """Where a collective of ``group`` on a tensor of ``device`` runs:
    "device" when the backend takes that device's tensors, else "host"
    (gloo with CUDA tensors) or "card" (NCCL with CPU tensors), a copy
    each way."""
    backend = dist.get_backend(group)
    on_card = device is not None and torch.device(device).type == "cuda"
    if backend == "nccl":
        return "device" if on_card else "card"
    return "host" if on_card else "device"


def _to_backend(tensor: torch.Tensor, where: str) -> torch.Tensor:
    """``tensor`` on the device that :func:`transport`'s ``where`` names:
    itself for "device", a host copy for "host", a card copy for "card"."""
    if where == "device":
        return tensor
    if where == "host":
        return tensor.cpu()
    return tensor.to(torch.device("cuda", torch.cuda.current_device()))


def _staged(op, tensor: torch.Tensor, group) -> None:
    """Run ``op(t)``, an in-place collective, on ``tensor`` where the
    group's backend takes it, copying through the other device otherwise."""
    where = transport(group, tensor.device)
    other = _to_backend(tensor, where)
    op(other)
    if other is not tensor:
        tensor.copy_(other)


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``."""
    _staged(lambda t: dist.all_reduce(t, group=group), tensor, group)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from global rank ``src``."""
    _staged(lambda t: dist.broadcast(t, src, group=group), tensor, group)
    return tensor


def all_gather(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (equal shapes), in group-rank order, on
    ``tensor``'s device."""
    where = transport(group, tensor.device)
    mine = _to_backend(tensor.contiguous(), where)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return parts if where == "device" else [p.to(tensor.device) for p in parts]


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (the ranks of one run
    unpickle only what their peers wrote)."""
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


class _Slot(NamedTuple):
    index: int
    shape: Tuple[int, ...]
    dtype: torch.dtype


def broadcast_tree(tree, src: int = 0):
    """Rank ``src``'s nest of dicts, lists and tuples of tensors and plain
    values on every rank, the tensors on the CPU: the structure in one
    object broadcast, then each tensor in one broadcast of its own (no
    pickle of the tensors' bytes)."""
    tensors: List[torch.Tensor] = []

    def strip(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return _Slot(len(tensors) - 1, tuple(x.shape), x.dtype)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    skeleton = broadcast_object(strip(tree) if dist.get_rank() == src else None, src)

    def fill(x):
        if isinstance(x, _Slot):
            t = tensors[x.index] if tensors else torch.empty(x.shape, dtype=x.dtype)
            return broadcast_(t.cpu().contiguous(), src)
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fill(v) for v in x)
        return x

    return fill(skeleton)


def pmean_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Average float tensors over ``group`` in place, in one flat
    all-reduce."""
    tensors = list(tensors)
    if not tensors or group is None:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group).div_(dist.get_world_size(group))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; backward sums the gradients over it too. Right
    where each rank's loss is its own and the objective is their sum (or
    mean): sync-BN's statistics."""
    return _AllReduceSum.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; backward passes the gradient through. Megatron's
    row-parallel output: every peer computes the same loss from the sum, so
    summing the gradient too would count it ``group size`` times."""
    return _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward sums the gradient over ``group``. Megatron's
    column-parallel input: each peer's shard contributes part of it."""
    return _CopyToGroup.apply(x, group)
