"""Kernels of the port: hand-written CUDA for Hopper, each with its plain PyTorch version."""

from .flash_attention import fused_attention_mh, set_attention_backend
from .layer_norm import fused_layer_norm, set_layernorm_backend
from .ln_dense import fused_ln_denses, set_lndense_backend
from .ln_mlp import fused_ln_mlp

__all__ = [
    "fused_attention_mh",
    "set_attention_backend",
    "fused_ln_denses",
    "set_lndense_backend",
    "fused_ln_mlp",
    "fused_layer_norm",
    "set_layernorm_backend",
]
