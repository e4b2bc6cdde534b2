"""Parallelism on ``torch.distributed``: the process group, the device mesh and its
collectives, and x-stream sequence parallelism (:mod:`.xsp`)."""

from .distributed import host_mean, initialize, is_lead_host
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_rank,
    batch_sharding,
    fold_in_process,
    gather_shares,
    local_share,
    local_batch_slice,
    make_mesh,
    model_group,
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
    "model_group",
    "axis_rank",
    "local_share",
    "gather_shares",
]
