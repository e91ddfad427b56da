"""Parallel training and evaluation on ``torch.distributed``, one process
per rank (counterpart of ``fenet/parallel``): data parallelism with sync-BN.

fenet's ``batch_sharding``, ``replicate``, ``shard_batch`` and
``shard_map_batch`` place arrays on a device mesh; here each process holds
its own shard already, so they have no counterpart. Nor have fenet's
tensor parallelism (``fenet/parallel/tp.py``) and ring-sharded chamfer
(``fenet/parallel/sp.py``): they split what one TPU core's memory cannot
hold, and the model and its training state fit one H100 many times over.
"""

from fenet_torch.parallel.distributed import (
    ProcessShardDataset,
    initialize,
    is_primary,
    local_batch_size,
    shard_for_process,
)
from fenet_torch.parallel.mesh import Mesh, make_mesh, pmean_

__all__ = [
    "Mesh",
    "ProcessShardDataset",
    "initialize",
    "is_primary",
    "local_batch_size",
    "make_mesh",
    "pmean_",
    "shard_for_process",
]
