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
from .embeddings import build_2d_sincos_position_embedding, fourier_pe, timestep_embedding
from .encoders import (
    ClassEmbedding,
    DepthMapEncoder,
    PartialPointCloudEncoder,
    ViewAngleEmbedding,
)
from .rin import ComputeBlock, DenoiserBackbone, RCWBlock, ReadBlock, WriteBlock
from .rotary import (
    RotaryPartialPointCloudEncoder,
    RotarySelfAttention,
    RotaryTransformerLayer,
    apply_rotary_pos_emb,
)
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
    "fourier_pe",
    "ClassEmbedding",
    "ViewAngleEmbedding",
    "PartialPointCloudEncoder",
    "DepthMapEncoder",
    "RotaryPartialPointCloudEncoder",
    "RotarySelfAttention",
    "RotaryTransformerLayer",
    "apply_rotary_pos_emb",
    "ComputeBlock",
    "ReadBlock",
    "WriteBlock",
    "RCWBlock",
    "DenoiserBackbone",
    "TwoStreamDenoiser",
    "MODALITY_TOKEN_IDS",
    "BoundTwoStream",
]
