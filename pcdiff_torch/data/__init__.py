"""Data of the port: synthetic batches shaped like the loaders' output."""

from .synthetic import synthetic_batch

__all__ = ["synthetic_batch"]
