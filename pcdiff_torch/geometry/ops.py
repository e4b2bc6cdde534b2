"""Point-set distances over channels-last ``[B, N, C]`` point sets.

Counterpart of :mod:`pcdiff.geometry.ops` for what the training loss needs. Pairwise
distances use the ``|a|^2 + |b|^2 - 2 a.b`` expansion with the product in fp32 and the
result clamped at 0, as the JAX package's; the product is a plain ``torch.matmul``, as the
JAX package leaves it to XLA. The nearest-neighbour minima are ``amin``, whose gradient,
like ``jnp.min``'s, is shared evenly between tied entries.
"""

from __future__ import annotations

import torch

__all__ = ["square_distance", "chamfer_distance", "chamfer_distance_xyz"]


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distances: src [B, N, C], dst [B, M, C] -> [B, N, M] fp32."""
    src, dst = src.float(), dst.float()
    cross = torch.matmul(src, dst.transpose(-1, -2))
    s2 = (src * src).sum(dim=-1, keepdim=True)  # [B, N, 1]
    d2 = (dst * dst).sum(dim=-1, keepdim=True)  # [B, M, 1]
    return torch.clamp_min(s2 + d2.transpose(-1, -2) - 2.0 * cross, 0.0)


def chamfer_distance(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared-L2 chamfer distance -> [B]: the mean nearest-neighbour squared distance of
    each side, summed over both directions."""
    d = square_distance(p1, p2)
    return d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)


def chamfer_distance_xyz(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Chamfer on the first three (XYZ) channels of [B, N, C >= 3] point sets."""
    return chamfer_distance(p1[..., :3], p2[..., :3])
