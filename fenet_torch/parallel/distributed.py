"""Multi-process runs on ``torch.distributed``, one process per rank
(counterpart of ``fenet/parallel/distributed.py``).

Call :func:`initialize` once per process, before any collective; it does
nothing on a single process. Each process feeds only its own shard of every
global batch: wrap the dataset in :class:`ProcessShardDataset` and size the
DataLoader with :func:`local_batch_size`. ``train_net`` and the eval CLIs
wire this up themselves when the world has more than one rank.

The cluster comes from the arguments, else from fenet's variables
(``COORDINATOR_ADDRESS`` or ``JAX_COORDINATOR_ADDRESS`` as ``host:port``,
``FENET_NUM_PROCESSES``, ``FENET_PROCESS_ID``), else from torchrun's
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is
the ``backend`` argument, else ``FENET_DIST_BACKEND``, else NCCL for a CUDA
device and gloo for the CPU. NCCL refuses two ranks on one card: ranks that
share a card name gloo, whose collectives on CUDA tensors this package
stages through host memory (see :mod:`fenet_torch.parallel.mesh`). A rank's
card is ``cuda:(local_rank % device_count)``, its local rank ``LOCAL_RANK``
or else its rank.

Every process group is made with a timeout (``timeout_s``): a rank that
dies leaves its peers blocked in a collective only until then.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(f"{name} must be set beside the coordinator address")
    return int(value)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group, or do nothing on a single process.

    Returns True when this process is (now) part of a process group. A
    world of one initializes too when the environment names a coordinator,
    so that a one-rank run exercises the backend.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
        if coordinator_address is not None:
            num_processes = _env_int("FENET_NUM_PROCESSES")
            process_id = _env_int("FENET_PROCESS_ID")
        elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{_env_int('MASTER_PORT')}"
            num_processes, process_id = _env_int("WORLD_SIZE"), _env_int("RANK")
        else:
            return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator address, the number of "
                         "processes and this process's id")
    if backend is None:
        backend = env.get("FENET_DIST_BACKEND") or (
            "nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card; name gloo for the CPU")
        # NCCL binds a rank to the current card; set it before the group.
        torch.cuda.set_device(local_rank(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def finalize() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(rank: Optional[int] = None) -> int:
    """This process's index among the processes of its host: ``LOCAL_RANK``
    (torchrun sets it), else its rank."""
    value = os.environ.get("LOCAL_RANK")
    if value is not None:
        return int(value)
    return process_rank() if rank is None else rank


def is_primary() -> bool:
    """True on the process that owns the files of a run (checkpoints,
    scalars, the log)."""
    return process_rank() == 0


def local_batch_size(global_batch: int, process_count: Optional[int] = None) -> int:
    """Each process's slice of a global batch; it must divide evenly: a
    ragged split would give processes different step counts and deadlock
    the collectives."""
    n = world_size() if process_count is None else process_count
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def shard_for_process(dataset):
    """``dataset`` wrapped in :class:`ProcessShardDataset` on a multi-process
    run, else unchanged: each process evaluates only its shard, and
    ``evaluate_dataset`` sums the shards."""
    if world_size() > 1:
        return ProcessShardDataset(dataset)
    return dataset


class ProcessShardDataset:
    """The ``process_index``-th strided shard of a dataset.

    Every process runs the same number of steps an epoch (each step is a
    collective), so the shards are padded to equal length by wrapping
    around inside the shard: at most one duplicate sample a process an
    epoch. The duplicates sit at the end of the shard and their count is
    ``wrap_duplicates``, so that exact consumers (``evaluate_dataset``)
    leave them out of their sums. A dataset smaller than the process count
    gives each process one sample, all of them duplicates on the processes
    that wrapped.

    ``load_batch``, the native whole-batch path, is forwarded through the
    index map; without it every multi-process batch would be read item by
    item.
    """

    def __init__(self, dataset, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        pi = process_rank() if process_index is None else process_index
        pc = world_size() if process_count is None else process_count
        if not 0 <= pi < pc:
            raise ValueError(f"process_index {pi} out of range for {pc}")
        n = len(dataset)
        if n == 0:
            raise ValueError(f"cannot shard an empty dataset over {pc}")
        idx = np.arange(pi, n, pc)
        wrap = 0
        if len(idx) == 0:  # more processes than samples
            idx = np.asarray([pi % n])
            wrap = 1
        target = max(-(-n // pc), 1)  # the longest shard's length
        if len(idx) < target:
            wrap = target - len(idx)
            idx = np.concatenate([idx, idx[:wrap]])
        self.dataset = dataset
        self._indices = idx
        self.wrap_duplicates = wrap

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self._indices[i])]

    def load_batch(self, indices):
        load = getattr(self.dataset, "load_batch", None)
        if load is None:
            return None
        return load([int(self._indices[i]) for i in indices])
