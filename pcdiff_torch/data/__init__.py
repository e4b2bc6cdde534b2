"""Data of the port: the ModelNet-completion dataset (``.npz`` or ``.h5``), batching, and
synthetic batches and fixtures."""

from .loader import BatchLoader
from .modelnet import (
    DEFAULT_SKIP_CLASSES,
    TRAIN_SKIP_INSTANCES,
    ModelNetCompletion,
    build_viewpoint_table,
    export_instance_ground_truths,
    h5_to_npz,
)
from .synthetic import (
    SYNTHETIC_CLASSES,
    make_modelnet_fixture,
    make_shapes_fixture,
    synthetic_batch,
)

__all__ = [
    "BatchLoader",
    "ModelNetCompletion",
    "build_viewpoint_table",
    "DEFAULT_SKIP_CLASSES",
    "TRAIN_SKIP_INSTANCES",
    "export_instance_ground_truths",
    "h5_to_npz",
    "synthetic_batch",
    "make_modelnet_fixture",
    "make_shapes_fixture",
    "SYNTHETIC_CLASSES",
]
