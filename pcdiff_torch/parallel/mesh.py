"""The device mesh and the data-parallel helpers, and the collectives of
the model axis.

Counterpart of :mod:`pcdiff.parallel.mesh` in PyTorch's idiom: a ``(data, model)``
:class:`torch.distributed.device_mesh.DeviceMesh` over the process group (one card a
process), the batch split over ``data`` and the parameters replicated. The gradient
average that XLA inserts under the JAX package's sharded step is an explicit all-reduce
over the data group (:func:`pcdiff_torch.train.average_gradients`). The mesh needs a
started process group (:func:`pcdiff_torch.parallel.initialize`); without one (a world of
one) :func:`make_mesh` returns None and every helper treats this process as the whole
data axis.

The model axis splits one replicated computation into equal shares (the x-stream's points
under :mod:`pcdiff_torch.parallel.xsp`, heads, window positions). Its collectives use only
``all_reduce`` (SUM, MAX) and ``broadcast``: a gather is a SUM over a zero-filled buffer.
On one card several ranks can only form a gloo group, and gloo takes CUDA tensors for
those two and not for ``all_gather``. Each collective that carries a gradient is an
autograd Function whose backward gives the dense gradient when every rank computes the
same loss: a replicated input used against a shard gets its gradient summed over the axis
(:func:`sum_gradients`), and a sum of partials, whose output is replicated, passes its
gradient through unchanged (:func:`sum_partials`).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .distributed import process_count, process_index

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "data_group",
    "model_group",
    "axis_rank",
    "sum_partials",
    "sum_gradients",
    "max_over",
    "local_share",
    "gather_shares",
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


def model_group(mesh):
    """The process group of the mesh's model axis, or None without a mesh."""
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def axis_rank(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis' size); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    import torch.distributed as dist

    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        import torch.distributed as dist

        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        return _all_reduce(grad, ctx.mesh, ctx.axis, dist.ReduceOp.SUM), None, None


def sum_partials(x: torch.Tensor, mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x`` (``psum``); its output is
    replicated, so its gradient reaches each partial unchanged."""
    return _SumPartials.apply(x, mesh, axis)


def sum_gradients(x: torch.Tensor, mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` itself, replicated over ``axis`` and about to be used against this rank's
    shard: its gradient is summed over ``axis``, so that every rank holds the dense one."""
    return _SumGradients.apply(x, mesh, axis)


def max_over(x: torch.Tensor, mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The elementwise max over ``axis`` (``pmax``), without a gradient."""
    import torch.distributed as dist

    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def local_share(x: torch.Tensor, mesh, axis: str = MODEL_AXIS, dim: int = 1
                ) -> torch.Tensor:
    """This rank's equal share along ``dim`` of ``x``, which is replicated over ``axis``;
    the share's gradient is summed over ``axis`` into the whole ``x``'s."""
    i, n = axis_rank(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} along dim {dim} do not split over {n} ranks")
    per = x.shape[dim] // n
    return sum_gradients(x, mesh, axis).narrow(dim, i * per, per)


def gather_shares(x: torch.Tensor, mesh, axis: str = MODEL_AXIS, dim: int = 1
                  ) -> torch.Tensor:
    """The inverse of :func:`local_share`: every rank's share along ``dim``, in rank
    order, on every rank (a SUM over a zero-filled buffer)."""
    i, n = axis_rank(mesh, axis)
    shape = list(x.shape)
    before, after = list(shape), list(shape)
    before[dim], after[dim] = i * shape[dim], (n - 1 - i) * shape[dim]
    buf = torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim=dim)
    return sum_partials(buf, mesh, axis)


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
