"""Parallel training and evaluation on ``torch.distributed``, one process
per rank (counterpart of ``fenet/parallel``): data parallelism with sync-BN,
Megatron tensor parallelism of the decoder's heads (:mod:`.tp`) and the
ring-sharded chamfer over the point axis (:mod:`.sp`).

fenet's ``batch_sharding``, ``replicate``, ``shard_batch`` and
``shard_map_batch`` place arrays on a device mesh; here each process holds
its own shard already, so they have no counterpart.
"""

from fenet_torch.parallel.distributed import (
    ProcessShardDataset,
    batch_process_groups,
    initialize,
    is_primary,
    local_batch_size,
    shard_for_process,
)
from fenet_torch.parallel.mesh import Mesh, make_mesh, pmean_
from fenet_torch.parallel.sp import make_sharded_chamfer, shard_points

__all__ = [
    "Mesh",
    "ProcessShardDataset",
    "batch_process_groups",
    "initialize",
    "is_primary",
    "local_batch_size",
    "make_mesh",
    "make_sharded_chamfer",
    "pmean_",
    "shard_for_process",
    "shard_points",
]
