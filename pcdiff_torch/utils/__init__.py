"""Host-side utilities of the port: saving batches of point clouds."""

from .io import save_samples, save_target_point_clouds

__all__ = ["save_samples", "save_target_point_clouds"]
