"""The point-cloud SDF model for mesh extraction: a transformer encodes the cloud once
(:meth:`CrossAttentionPointCloudSDFModel.encode_point_clouds`), then a perceiver decoder
cross-attends batches of query points to the cached latents
(:meth:`CrossAttentionPointCloudSDFModel.predict_sdf`).

Counterpart of :mod:`pcdiff.models.sdf`, in the fused graph (K3 for every pre-LN
projection, K1 for every attention). Channels-last: clouds ``[B, N, 3]``, queries
``[B, M, 3]`` -> SDF ``[B, M]`` (fp32).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .attention import LayerNorm
from .perceiver import SimplePerceiver
from .point_e import PointETransformer, _PointEDense

__all__ = ["CrossAttentionPointCloudSDFModel"]


class CrossAttentionPointCloudSDFModel(nn.Module):
    def __init__(self, n_ctx: int = 4096, width: int = 512, encoder_layers: int = 12,
                 encoder_heads: int = 8, decoder_layers: int = 4, decoder_heads: int = 8,
                 init_scale: float = 0.25, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.n_ctx, self.dtype = n_ctx, dtype
        std = init_scale * math.sqrt(1.0 / width)
        self.encoder_input_proj = _PointEDense(3, width, std, dtype, device)
        self.encoder = PointETransformer(width, encoder_layers, encoder_heads, init_scale,
                                         dtype, device)
        self.decoder_input_proj = _PointEDense(3, width, std, dtype, device)
        self.decoder = SimplePerceiver(width, decoder_layers, decoder_heads, init_scale,
                                       dtype=dtype, device=device)
        self.ln_post = LayerNorm(width, dtype=dtype, device=device)
        self.output_proj = _PointEDense(width, 1, std, torch.float32, device)
        self.eval()

    @property
    def default_batch_size(self) -> int:
        return self.n_ctx

    def encode_point_clouds(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(latents=self.encoder(self.encoder_input_proj(point_clouds)))

    def predict_sdf(self, x: torch.Tensor, encoded: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = self.decoder(self.decoder_input_proj(x), encoded["latents"])
        return self.output_proj(self.ln_post(h))[..., 0]

    def forward(self, x: torch.Tensor, point_clouds: Optional[torch.Tensor] = None,
                encoded: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        if (point_clouds is None) == (encoded is None):
            raise ValueError("pass one of point_clouds and encoded")
        if point_clouds is not None:
            encoded = self.encode_point_clouds(point_clouds)
        return self.predict_sdf(x, encoded)
