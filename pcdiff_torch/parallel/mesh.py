"""The device mesh and the data-parallel helpers.

Counterpart of :mod:`pcdiff.parallel.mesh` in PyTorch's idiom: a ``(data, model)``
:class:`torch.distributed.device_mesh.DeviceMesh` over the process group (one card a
process), the batch split over ``data`` and the parameters replicated. The gradient
average that XLA inserts under the JAX package's sharded step is an explicit all-reduce
over the data group (:func:`pcdiff_torch.train.average_gradients`). The mesh needs a
started process group (:func:`pcdiff_torch.parallel.initialize`); without one (a world of
one) :func:`make_mesh` returns None and every helper treats this process as the whole
data axis.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .distributed import process_count, process_index

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "data_group",
    "shard_batch",
    "replicate",
    "local_batch_slice",
    "fold_in_process",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(device_type: Optional[str] = None, data_parallel: Optional[int] = None,
              model_parallel: int = 1):
    """A (data, model) mesh over every process of the group (``device_type`` the group's:
    ``cuda`` under NCCL, else ``cpu``), or None without a process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if data_parallel is None:
        assert n % model_parallel == 0, (n, model_parallel)
        data_parallel = n // model_parallel
    assert data_parallel * model_parallel == n, (data_parallel, model_parallel, n)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(n).reshape(data_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh) -> tuple:
    """The DTensor placements of a batch: the leading axis split over ``data``,
    replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated_sharding(mesh) -> tuple:
    """The DTensor placements of a parameter: replicated over both axes."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def data_group(mesh):
    """The process group of the mesh's data axis, or None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def _data_rank(mesh) -> tuple:
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of a global batch (a dict of arrays or tensors, rank order = row
    order): the whole batch without a mesh."""
    i, n = _data_rank(mesh)
    if n == 1:
        return batch

    def rows(x):
        assert x.shape[0] % n == 0, (x.shape, n)
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return {k: rows(v) for k, v in batch.items()} if isinstance(batch, dict) else rows(batch)


def replicate(mesh, tree: Any) -> Any:
    """Rank 0's values of ``tree`` (a module, a dict of tensors or a tensor) on every rank
    of the data axis, broadcast in place; returns ``tree``."""
    if mesh is None:
        return tree
    import torch.distributed as dist

    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return tree


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally indexed batch (the ``DistributedSampler``
    contract: the ``process_index()``-th of ``process_count()`` equal parts)."""
    n = process_count()
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def fold_in_process(seed: int, device="cpu") -> torch.Generator:
    """A generator of this process's own stream: ``seed`` offset by the rank (the
    reference's seed + rank). The train step's generator is seeded alike on every rank
    instead (its draws are the global batch's)."""
    return torch.Generator(device=device).manual_seed(seed + process_index())
