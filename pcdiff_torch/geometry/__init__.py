"""Point-set geometry of the port: distances and F-scores, FPS (and the native host
FPS, :mod:`.fps_native`), PLY IO and the ``PointCloud`` and ``TriMesh`` containers."""

from .fps import farthest_point_sample, fps
from .mesh import TriMesh
from .ops import (
    chamfer_distance,
    chamfer_distance_color,
    chamfer_distance_xyz,
    fscore,
    fscore_squared,
    index_points,
    knn,
    square_distance,
)
from .ply import read_ply, write_ply
from .point_cloud import PointCloud

__all__ = [
    "PointCloud",
    "TriMesh",
    "write_ply",
    "read_ply",
    "square_distance",
    "chamfer_distance",
    "chamfer_distance_xyz",
    "chamfer_distance_color",
    "fscore",
    "fscore_squared",
    "index_points",
    "knn",
    "farthest_point_sample",
    "fps",
]
