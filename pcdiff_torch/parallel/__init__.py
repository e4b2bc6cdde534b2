"""Data parallelism on ``torch.distributed``: the process group and the device mesh."""

from .distributed import host_mean, initialize, is_lead_host
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    fold_in_process,
    local_batch_slice,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "initialize",
    "is_lead_host",
    "host_mean",
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "local_batch_slice",
    "fold_in_process",
]
