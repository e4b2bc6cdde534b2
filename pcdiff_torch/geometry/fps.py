"""Farthest point sampling (FPS).

Counterpart of :mod:`pcdiff.geometry.fps`: a loop over the samples of one [B, N] update
each (the distance to the newest centroid, the running minimum, its argmax). Distances
are taken in fp32 at least (fp64 stays fp64), since a coarser compare flips indices at
near-ties; the squared distance sums its channels in order.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["farthest_point_sample", "fps"]


@torch.no_grad()
def farthest_point_sample(points: torch.Tensor, num_samples: int, *,
                          generator: Optional[torch.Generator] = None,
                          deterministic: bool = False, row_offset: int = 0) -> torch.Tensor:
    """Indices [B, num_samples] (int64) of farthest points of ``points`` [B, N, C].

    ``deterministic=True`` (or no ``generator``) seeds batch element b at point index
    (``row_offset`` + b) mod N, the reference's evaluation mode (``row_offset``: the
    rows' place in a larger batch, as a rank's share of one); otherwise ``generator``
    draws each start.
    """
    b, n, c = points.shape
    if points.dtype not in (torch.float32, torch.float64):
        points = points.float()
    dev = points.device
    if deterministic or generator is None:
        farthest = (torch.arange(b, device=dev) + row_offset) % n
    else:
        farthest = torch.randint(0, n, (b,), generator=generator, device=dev)
    rows = torch.arange(b, device=dev)
    idx = torch.zeros(b, num_samples, dtype=torch.long, device=dev)
    dist = torch.full((b, n), torch.finfo(points.dtype).max, dtype=points.dtype, device=dev)
    for i in range(num_samples):
        idx[:, i] = farthest
        centroid = points[rows, farthest][:, None, :]  # [B, 1, C]
        diff = points - centroid
        d = diff[..., 0] * diff[..., 0]
        for ch in range(1, c):
            d = d + diff[..., ch] * diff[..., ch]
        dist = torch.minimum(dist, d)
        farthest = dist.argmax(dim=-1)
    return idx


def fps(points: torch.Tensor, num_samples: int, *,
        generator: Optional[torch.Generator] = None, deterministic: bool = False
        ) -> torch.Tensor:
    """FPS-downsample points [B, N, C] to [B, num_samples, C]."""
    idx = farthest_point_sample(points, num_samples, generator=generator,
                                deterministic=deterministic)
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))
