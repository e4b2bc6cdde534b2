"""Synthetic in-memory batches, the port's own copy of
:func:`pcdiff.data.synthetic.synthetic_batch` (numpy, the same draws from the same
generator), for the train step's smoke runs and tests."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["synthetic_batch"]


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    num_points: int = 1024,
    num_partial: int = 1024,
    depth_size: int = 512,
    num_classes: int = 10,
) -> Dict[str, np.ndarray]:
    """A random batch shaped like the ModelNet loader's output (channels-last; depth maps
    NHWC)."""
    return dict(
        target=rng.uniform(-0.5, 0.5, (batch_size, num_points, 3)).astype(np.float32),
        class_labels=rng.integers(0, num_classes, (batch_size,)).astype(np.int32),
        partial_pcd=rng.uniform(-0.5, 0.5, (batch_size, num_partial, 3)).astype(
            np.float32),
        depth_maps=rng.random((batch_size, depth_size, depth_size, 1)).astype(np.float32),
        viewpoints=rng.standard_normal((batch_size, 3)).astype(np.float32),
    )
