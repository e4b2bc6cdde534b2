"""Batch point-cloud save helpers.

The port's own copy of :mod:`pcdiff.utils.io`: write a batch of [B, N, 3] clouds as
numbered PLY (or npz) files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..geometry.point_cloud import PointCloud

__all__ = ["save_samples", "save_target_point_clouds"]


def save_target_point_clouds(
    batch_points: np.ndarray,
    out_dir: str,
    prefix: str = "target",
    colors: Optional[np.ndarray] = None,
    fmt: str = "ply",
) -> None:
    """Write each cloud of a [B, N, 3] batch to ``<prefix>_<i+1>.<fmt>``."""
    os.makedirs(out_dir, exist_ok=True)
    batch_points = np.asarray(batch_points)
    for i, pts in enumerate(batch_points):
        channels = {}
        if colors is not None:
            c = np.asarray(colors[i] if colors.ndim == 3 else colors)
            channels = {k: c[:, j] for j, k in enumerate("RGB")}
        pc = PointCloud(coords=np.asarray(pts, dtype=np.float32),
                        channels=channels)
        path = os.path.join(out_dir, f"{prefix}_{i + 1}.{fmt}")
        if fmt == "ply":
            with open(path, "wb") as f:
                pc.write_ply(f)
        else:
            pc.save(path)


def save_samples(samples: np.ndarray, out_dir: str, fmt: str = "ply") -> None:
    """Write a sampled [B, N, 3] batch as ``sample_<i+1>.<fmt>``."""
    save_target_point_clouds(samples, out_dir, prefix="sample", fmt=fmt)
