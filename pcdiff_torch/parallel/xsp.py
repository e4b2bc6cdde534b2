"""x-stream sequence parallelism: the point tokens sharded over the mesh's model axis.

Counterpart of :mod:`pcdiff.parallel.xsp`. The RIN backbone spends two cross-attentions a
block on the points and its quadratic work on the latents, so the points shard well:

- **x sharded** on the token axis over the ``model`` axis, z replicated;
- **read attention** (z queries x): a local partial attention a shard with a globally
  normalised softmax: the local row max, its MAX over the axis, then the SUMs of the
  normaliser and of the value-weighted partials;
- **write attention** (x queries z): k and v replicated, the queries local: no collective
  in the forward;
- **head attention**: each rank takes its group of heads of replicated tokens and the
  heads are put back together (the JAX package leaves that step to GSPMD in the output
  projection);
- the x-side projections, MLPs and LayerNorms run on the local rows.

Where JAX's ``shard_map`` takes global arrays, each rank here holds its own shard: the
read attention's k and v are this rank's tokens, the write attention's q is. q is
pre-scaled, the logits are fp32, and the local math is plain PyTorch matmuls and softmax,
as the JAX package's is plain XLA. The gradients are the dense ones when every rank
computes the same loss (:mod:`pcdiff_torch.parallel.mesh`): q in read and k, v in write
are replicated inputs used against a shard, so their gradients are summed over the axis.
A parameter that acts on the local rows gets this rank's part of its gradient:
:func:`sum_point_gradients` sums those over the axis after ``backward``.

A model shards its points when its read hook is :func:`sharded_read_attention` bound to a
mesh with ``functools.partial(sharded_read_attention, mesh=mesh)``, as the JAX package's
dryrun binds it (:func:`point_mesh`).
"""

from __future__ import annotations

import functools
from typing import Any, Iterable, Optional, Tuple

import torch

from .mesh import (
    MODEL_AXIS,
    gather_shares,
    local_share,
    max_over,
    sum_gradients,
    sum_partials,
)

__all__ = [
    "sharded_read_attention",
    "sharded_write_attention",
    "sharded_head_attention",
    "local_attention",
    "point_mesh",
    "local_points",
    "gather_points",
    "sum_point_gradients",
]


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v on [B, H, N, D] with fp32 logits and softmax, the weights in q's
    dtype (q pre-scaled): what each rank computes locally, and the one-process plain
    version of the three primitives (the JAX module's ``_local_attention``)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v.to(q.dtype))


def sharded_read_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis: str = MODEL_AXIS) -> torch.Tensor:
    """Attention of replicated queries q [B, H, Nq, D] over this rank's keys and values
    k, v [B, H, Nk / n, D] of the tokens sharded over ``axis``; returns the replicated
    [B, H, Nq, D]. out = SUM(exp(l - m) v) / SUM(exp(l - m)) with m the MAX of the local
    row maxes, which carries no gradient (the softmax does not depend on it). The partial
    sums are taken in fp32."""
    q = sum_gradients(q, mesh, axis)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = max_over(logits.detach().amax(dim=-1), mesh, axis)
    p = torch.exp(logits - m[..., None])
    denom = sum_partials(p.sum(dim=-1), mesh, axis)
    out = sum_partials(torch.matmul(p.to(v.dtype), v).float(), mesh, axis)
    return (out / denom[..., None]).to(q.dtype)


def sharded_write_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                            axis: str = MODEL_AXIS) -> torch.Tensor:
    """Attention of this rank's queries q [B, H, Nq / n, D] over replicated k and v: local,
    with no collective in the forward."""
    return local_attention(q, sum_gradients(k, mesh, axis), sum_gradients(v, mesh, axis))


def sharded_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis: str = MODEL_AXIS) -> torch.Tensor:
    """Tensor-parallel attention: of replicated q, k, v [B, H, N, D] this rank computes
    its H / n heads, and the heads are put back together on every rank."""
    q, k, v = (local_share(t, mesh, axis, dim=1) for t in (q, k, v))
    return gather_shares(local_attention(q, k, v), mesh, axis, dim=1)


def _bound_mesh(fn, primitive) -> Optional[Tuple[Any, str]]:
    if isinstance(fn, functools.partial) and fn.func is primitive:
        kw = fn.keywords
        if "mesh" not in kw:
            raise ValueError(f"bind {primitive.__name__}'s mesh by keyword "
                             "(functools.partial(..., mesh=mesh))")
        return kw["mesh"], kw.get("axis", MODEL_AXIS)
    return None


def point_mesh(read_attention_fn, write_attention_fn) -> Optional[Tuple[Any, str]]:
    """(mesh, axis) over which a model with these read and write hooks shards the
    x-stream's points, or None: its read hook is :func:`sharded_read_attention` bound to
    a mesh. A sharded write hook needs the read hook sharded over the same mesh and axis
    (its backward sums k's and v's gradients over the axis)."""
    read = _bound_mesh(read_attention_fn, sharded_read_attention)
    write = _bound_mesh(write_attention_fn, sharded_write_attention)
    if write is not None and (read is None or write[0] is not read[0] or write[1] != read[1]):
        raise ValueError("the write hook shards the points over another mesh or axis than "
                         "the read hook")
    return read


def local_points(x: torch.Tensor, points: Optional[Tuple[Any, str]]) -> torch.Tensor:
    """This rank's points of the whole cloud ``x`` [B, N, C] (``x`` itself for None)."""
    return x if points is None else local_share(x, *points, dim=1)


def gather_points(x: torch.Tensor, points: Optional[Tuple[Any, str]]) -> torch.Tensor:
    """The whole cloud [B, N, C] from every rank's points (``x`` itself for None)."""
    return x if points is None else gather_shares(x, *points, dim=1)


def sum_point_gradients(params: Iterable[torch.nn.Parameter], mesh,
                        axis: str = MODEL_AXIS) -> None:
    """Sum over ``axis``, in place, the gradients of parameters that act on the local
    points (``DenoiserBackbone.point_parameters``): each rank's holds its rows' part. One
    fp32 all-reduce; a missing gradient takes part as zeros, so every rank reduces the
    same layout."""
    import torch.distributed as dist

    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                      .reshape(-1) for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    offset = 0
    for p in params:
        part = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
        if p.grad is None:
            p.grad = part.to(p.dtype).clone()
        else:
            p.grad.copy_(part)
