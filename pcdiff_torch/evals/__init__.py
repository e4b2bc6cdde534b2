"""Evaluation of the port: completion CD/F1, per class and overall; PointNet++ features
and P-FID/P-IS statistics; npz streaming of sample batches."""

from .fid_is import (
    FIDStatistics,
    compute_inception_score,
    compute_statistics,
)
from .metrics import CompletionMetrics, batch_cd_f1
from .npz_stream import NpzStreamer, NumpyArrayInfo
from .pointnet2 import (
    PointNet2ClassifierSSG,
    PointNetSetAbstraction,
    import_pointnet2_torch_state,
    pointnet2_state_from_flax,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
)

__all__ = [
    "FIDStatistics",
    "compute_statistics",
    "compute_inception_score",
    "CompletionMetrics",
    "batch_cd_f1",
    "NpzStreamer",
    "NumpyArrayInfo",
    "PointNet2ClassifierSSG",
    "PointNetSetAbstraction",
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
    "import_pointnet2_torch_state",
    "pointnet2_state_from_flax",
]
