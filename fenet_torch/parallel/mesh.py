"""The data-parallel process mesh and its collectives (counterpart of
``fenet/parallel/mesh.py``).

fenet shards one program over a device mesh with ``shard_map``. Here each
rank is a process, and every rank holds the whole model: the mesh is the
world of ranks, over which gradients, losses and BatchNorm statistics are
averaged. fenet's model axis (Megatron tensor parallelism of the decoder's
heads) has no counterpart: it splits ``fc1_1`` because a TPU core's memory
is small, and the whole training state fits one H100 many times over.

Transport: NCCL takes CUDA tensors and gloo takes CPU tensors. A collective
here runs on the tensor where its group's backend takes it, and stages it
through the other device otherwise; that is chosen by the backend, never by
catching an error (:func:`transport`). So two ranks that share one card
run on gloo, with each collective copied through host memory.

One differentiable collective, :func:`all_reduce_sum` (sum forward, sum
backward): sync-BN's statistics, where every rank's loss depends on every
rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from fenet_torch.parallel.distributed import world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel mesh: its size and the group of its ranks (None on
    one process)."""

    dp: int = 1
    group: Optional[dist.ProcessGroup] = None


LAUNCH_HINT = (
    "launch one process per rank: torchrun --nproc_per_node N -m "
    "fenet_torch.cli.train ..., or set COORDINATOR_ADDRESS=host:port, "
    "FENET_NUM_PROCESSES and FENET_PROCESS_ID in each process "
    "(FENET_DIST_BACKEND=gloo for ranks that share one card)")


def make_mesh(data_parallel: int = 1) -> Mesh:
    """The mesh over every rank of the process group. ``data_parallel`` 1
    sizes it to the world, as fenet's driver does; any other value must be
    the world size."""
    world = world_size()
    dp = world if data_parallel <= 1 else int(data_parallel)
    if dp != world:
        raise ValueError(f"data_parallel {dp} needs {dp} processes, this run has {world}; "
                         f"{LAUNCH_HINT}")
    if world == 1:
        return Mesh()
    return Mesh(dp, dist.group.WORLD)


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


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; backward sums the gradients over it too. Right
    where each rank's loss is its own and the objective is their sum (or
    mean): sync-BN's statistics."""
    return _AllReduceSum.apply(x, group)
