"""Neural models of the port: the two-stream denoiser, its encoders and building blocks."""

from ..ops.flash_attention import fused_attention
from .attention import (
    CrossAttention,
    DecoderLayer,
    EncoderLayer,
    Mlp,
    dot_product_attention,
    fuse_ln_mlp_enabled,
    set_gelu_impl,
    set_ln_mlp_fusion,
)
from .embeddings import build_2d_sincos_position_embedding, timestep_embedding
from .encoders import (
    ClassEmbedding,
    DepthMapEncoder,
    PartialPointCloudEncoder,
    ViewAngleEmbedding,
)
from .rin import ComputeBlock, DenoiserBackbone, RCWBlock, ReadBlock, WriteBlock
from .two_stream import MODALITY_TOKEN_IDS, TwoStreamDenoiser
from .wrapper import BoundTwoStream

__all__ = [
    "CrossAttention",
    "EncoderLayer",
    "DecoderLayer",
    "Mlp",
    "dot_product_attention",
    "fused_attention",
    "set_gelu_impl",
    "set_ln_mlp_fusion",
    "fuse_ln_mlp_enabled",
    "timestep_embedding",
    "build_2d_sincos_position_embedding",
    "ClassEmbedding",
    "ViewAngleEmbedding",
    "PartialPointCloudEncoder",
    "DepthMapEncoder",
    "ComputeBlock",
    "ReadBlock",
    "WriteBlock",
    "RCWBlock",
    "DenoiserBackbone",
    "TwoStreamDenoiser",
    "MODALITY_TOKEN_IDS",
    "BoundTwoStream",
]
