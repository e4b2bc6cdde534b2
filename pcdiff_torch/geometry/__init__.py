"""Point-set geometry of the port."""

from .ops import chamfer_distance, chamfer_distance_xyz, square_distance

__all__ = ["square_distance", "chamfer_distance", "chamfer_distance_xyz"]
