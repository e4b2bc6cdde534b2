"""Neural models of the port: the two-stream denoiser, its encoders and building blocks."""

from .attention import CrossAttention, DecoderLayer, EncoderLayer, Mlp, set_gelu_impl
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
    "set_gelu_impl",
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
