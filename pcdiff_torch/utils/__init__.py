"""Host-side utilities of the port: saving batches of point clouds, and plotting them."""

from .io import save_samples, save_target_point_clouds
from .plotting import plot_point_cloud

__all__ = ["plot_point_cloud", "save_samples", "save_target_point_clouds"]
