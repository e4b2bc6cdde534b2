"""Data of the port: the ModelNet-completion, MVP and ShapeNet-multimodal datasets
(``.npz`` or ``.h5``), the file audit, batching, and synthetic batches and fixtures."""

from .loader import BatchLoader
from .modelnet import (
    DEFAULT_SKIP_CLASSES,
    TRAIN_SKIP_INSTANCES,
    ModelNetCompletion,
    build_viewpoint_table,
    export_instance_ground_truths,
    h5_to_npz,
)
from .multimodal import SHAPENET_LABEL_DICT, MultiModalCompletion
from .mvp import MVP_LABEL_DICT, MVPCompletion
from .qa import H5AuditReport, audit_modelnet_h5
from .synthetic import (
    SYNTHETIC_CLASSES,
    make_modelnet_fixture,
    make_multimodal_fixture,
    make_mvp_fixture,
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
    "MultiModalCompletion",
    "SHAPENET_LABEL_DICT",
    "MVPCompletion",
    "MVP_LABEL_DICT",
    "audit_modelnet_h5",
    "H5AuditReport",
    "synthetic_batch",
    "make_modelnet_fixture",
    "make_shapes_fixture",
    "make_mvp_fixture",
    "make_multimodal_fixture",
    "SYNTHETIC_CLASSES",
]
