"""Matplotlib 3D scatter grids of point clouds.

The port's own copy of :mod:`pcdiff.utils.plotting`: a grid of fixed rotations of one
cloud, its RGB channels as colours where it has them, fixed or tight axis bounds.
matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..geometry.point_cloud import PointCloud

__all__ = ["plot_point_cloud"]


def plot_point_cloud(
    pc: PointCloud,
    color: bool = True,
    grid_size: int = 1,
    fixed_bounds: Optional[tuple] = ((-0.75, -0.75, -0.75), (0.75, 0.75, 0.75)),
):
    """Render a point cloud as a grid_size x grid_size matplotlib figure of
    rotated views; returns the figure."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))

    if color and all(c in pc.channels for c in "RGB"):
        colors = np.stack([pc.channels[c] for c in "RGB"], axis=-1)
    else:
        colors = None

    for i in range(grid_size):
        for j in range(grid_size):
            ax = fig.add_subplot(
                grid_size, grid_size, 1 + j + i * grid_size, projection="3d"
            )
            theta = np.pi * 2 * (i * grid_size + j) / (grid_size**2)
            rotation = np.array(
                [
                    [np.cos(theta), -np.sin(theta), 0.0],
                    [np.sin(theta), np.cos(theta), 0.0],
                    [0.0, 0.0, 1.0],
                ]
            )
            coords = pc.coords @ rotation
            ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c=colors, s=2)
            if fixed_bounds is None:
                min_point = coords.min(0)
                max_point = coords.max(0)
                size = (max_point - min_point).max() / 2
                center = (min_point + max_point) / 2
                ax.set_xlim3d(center[0] - size, center[0] + size)
                ax.set_ylim3d(center[1] - size, center[1] + size)
                ax.set_zlim3d(center[2] - size, center[2] + size)
            else:
                ax.set_xlim3d(fixed_bounds[0][0], fixed_bounds[1][0])
                ax.set_ylim3d(fixed_bounds[0][1], fixed_bounds[1][1])
                ax.set_zlim3d(fixed_bounds[0][2], fixed_bounds[1][2])
    return fig
