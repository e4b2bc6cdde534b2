"""Point-set operations over channels-last ``[B, N, C]`` point sets.

Counterpart of :mod:`pcdiff.geometry.ops`: chamfer distances (the training loss's and the
evaluation's), F-scores, the batched gather and k nearest neighbours. Pairwise
distances use the ``|a|^2 + |b|^2 - 2 a.b`` expansion with the product in fp32 (in fp64
for fp64 inputs, where the JAX package stays in fp32) and the result clamped at 0; the
product is a plain ``torch.matmul``, as the JAX package leaves it to XLA. The
nearest-neighbour minima are ``amin``, whose gradient, like ``jnp.min``'s, is shared
evenly between tied entries.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "square_distance",
    "chamfer_distance",
    "chamfer_distance_xyz",
    "chamfer_distance_color",
    "fscore",
    "fscore_squared",
    "index_points",
    "knn",
]


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distances: src [B, N, C], dst [B, M, C] -> [B, N, M], in fp64
    where either input is fp64 (the extractor's fp64 mode) and in fp32 otherwise."""
    dtype = torch.float64 if torch.float64 in (src.dtype, dst.dtype) else torch.float32
    src, dst = src.to(dtype), dst.to(dtype)
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


def chamfer_distance_color(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Chamfer on the RGB channels (3:6) of [B, N, 6] point sets."""
    if p1.shape[-1] != 6 or p2.shape[-1] != 6:
        raise ValueError("color chamfer needs exactly 6 channels (XYZ+RGB)")
    return chamfer_distance(p1[..., 3:6], p2[..., 3:6])


def _f(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    return 2.0 * precision * recall / (precision + recall + 1e-8)


def fscore(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.03
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F-score at a Euclidean distance threshold: pred [B, N, 3], gt [B, M, 3] ->
    (fscore, precision, recall), each [B]. Precision is the share of predicted points
    within ``threshold`` of gt, recall the reverse."""
    d = square_distance(pred, gt)
    nn_pred = d.amin(dim=2).sqrt()
    nn_gt = d.amin(dim=1).sqrt()
    precision = (nn_pred < threshold).float().mean(dim=1)
    recall = (nn_gt < threshold).float().mean(dim=1)
    return _f(precision, recall), precision, recall


def fscore_squared(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 1e-4
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F-score thresholded on squared distances (the reference's squared variant)."""
    d = square_distance(pred, gt)
    precision = (d.amin(dim=2) < threshold).float().mean(dim=1)
    recall = (d.amin(dim=1) < threshold).float().mean(dim=1)
    return _f(precision, recall), precision, recall


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b = points.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def knn(query: torch.Tensor, points: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest neighbours of ``query`` [B, N, C] in ``points`` [B, M, C] ->
    (squared distances [B, N, k], indices [B, N, k]), nearest first."""
    d, idx = torch.topk(square_distance(query, points), k, dim=-1, largest=False, sorted=True)
    return d, idx
