"""Conditioning-modality encoders for the two-stream denoiser.

Counterpart of :mod:`pcdiff.models.encoders`:

- ``ClassEmbedding``: embedding + LayerNorm -> one token;
- ``ViewAngleEmbedding``: 3 -> D MLP (exact-erf GELUs, whatever ``set_gelu_impl`` says)
  -> one token;
- ``PartialPointCloudEncoder``: point projection -> [CLS | N] encoder -> learned-query
  decoder -> query refiner -> [CLS | T-1] tokens;
- ``DepthMapEncoder``: stride-``patch`` patchify conv over an NHWC depth map + fixed 2D
  sin-cos embedding -> mixer -> learned-query decoder -> refiner -> [CLS | T-1] tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Dense, DecoderLayer, EncoderLayer, LayerNorm, _xavier_uniform_
from .embeddings import build_2d_sincos_position_embedding

__all__ = [
    "Embed",
    "ClassEmbedding",
    "ViewAngleEmbedding",
    "PartialPointCloudEncoder",
    "DepthMapEncoder",
]


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of an fp32 table, returned in ``dtype``. An index in
    [-n, 0) counts from the end and one outside [-n, n) gives a row of NaN, as
    ``jnp.take``'s fill mode does there (an MVP label past ``num_classes``, say), where
    ``F.embedding`` would raise (on the card, a device-side assert)."""

    def __init__(self, num_embeddings: int, dim: int, init_std: float = 0.02,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.init_std = init_std
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.init_std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        ids = ids.long()
        ids = torch.where(ids < 0, ids + n, ids)
        inside = (ids >= 0) & (ids < n)
        rows = F.embedding(ids.clamp(0, n - 1), self.weight)
        return torch.where(inside[..., None], rows, float("nan")).to(self.dtype)


class PatchConv(nn.Module):
    """flax ``nn.Conv`` with kernel = stride = ``patch`` over NHWC input -> NHWC output.
    The image size must be a multiple of the patch (flax's SAME padding is then none).
    With kernel = stride the windows do not overlap, so the convolution is a reshape into
    patches and one matmul in ``dtype``: no convolution runs, so cuDNN's TF32 default for
    fp32 convolutions never applies (an fp32 matmul stays fp32 under PyTorch's default
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""

    def __init__(self, in_channels: int, out_channels: int, patch: int,
                 dtype: torch.dtype = torch.float32, device=None, use_bias: bool = True):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, patch, patch, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax kaiming_normal: truncated normal (+-2 sd) with variance 2 / fan_in
        fan_in = self.weight[0].numel()
        std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % self.patch or x.shape[2] % self.patch:
            raise ValueError(f"image {tuple(x.shape[1:3])} is not a multiple of the "
                             f"patch {self.patch}")
        b, h, w, cin = x.shape
        p = self.patch
        patches = (x.to(self.dtype).reshape(b, h // p, p, w // p, p, cin)
                   .permute(0, 1, 3, 5, 2, 4).reshape(b, h // p, w // p, cin * p * p))
        weight = self.weight.to(self.dtype).reshape(self.weight.shape[0], cin * p * p)
        return F.linear(patches, weight, None if self.bias is None else self.bias.to(self.dtype))


class ClassEmbedding(nn.Module):
    """Class label -> one normalised conditioning token [B, 1, D]."""

    def __init__(self, num_classes: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.embedding = Embed(num_classes, embed_dim, 0.02, dtype, device)
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)

    def forward(self, class_labels: torch.Tensor) -> torch.Tensor:
        return self.norm(self.embedding(class_labels))[:, None, :]


class ViewAngleEmbedding(nn.Module):
    """Camera viewpoint vector -> one conditioning token [B, 1, D]."""

    def __init__(self, input_dim: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(input_dim, embed_dim // 2, True, dtype, device)
        self.fc2 = Dense(embed_dim // 2, embed_dim, True, dtype, device)
        self.fc3 = Dense(embed_dim, embed_dim, True, dtype, device)
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)

    def forward(self, view_angles: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(view_angles.to(self.dtype)))
        h = F.gelu(self.fc2(h))
        return self.norm(self.fc3(h))[:, None, :]


class _QueryDecoder(nn.Module):
    """Shared tail of both heavy encoders: learned queries cross-attend to the encoded
    tokens, are residual-refined, then join the CLS token."""

    def __init__(self, embed_dim: int, num_tokens: int, num_layers: int, num_heads: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.depth = num_layers // 2
        self.token_queries = nn.Parameter(
            torch.empty(1, num_tokens - 1, embed_dim, device=device))
        for i in range(self.depth):
            setattr(self, f"decoder_{i}",
                    DecoderLayer(embed_dim, num_heads, dtype=dtype, device=device))
        for i in range(self.depth):
            setattr(self, f"refiner_{i}",
                    EncoderLayer(embed_dim, num_heads, dtype=dtype, device=device))
        self.proj_out = Dense(embed_dim, embed_dim, True, dtype, device)
        self.ln_out = LayerNorm(embed_dim, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, n, d = self.token_queries.shape
        _xavier_uniform_(self.token_queries, n, d, generator)

    def forward(self, cls_out: torch.Tensor, patch_tokens: torch.Tensor) -> torch.Tensor:
        b = patch_tokens.shape[0]
        tokens = self.token_queries.to(self.dtype).expand(b, -1, -1).contiguous()
        for i in range(self.depth):
            tokens = getattr(self, f"decoder_{i}")(tokens, patch_tokens)
        refined = tokens
        for i in range(self.depth):
            refined = getattr(self, f"refiner_{i}")(refined)
        tokens = torch.cat([cls_out, tokens + refined], dim=1)  # [B, T, D]
        return self.ln_out(self.proj_out(tokens))


class PartialPointCloudEncoder(nn.Module):
    """Partial-scan point cloud [B, N, 3] -> ``num_tokens`` conditioning tokens."""

    def __init__(self, input_dim: int = 3, embed_dim: int = 256, num_tokens: int = 256,
                 num_layers: int = 8, num_heads: int = 8, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.input_proj = Dense(input_dim, embed_dim, True, dtype, device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        for i in range(num_layers):
            setattr(self, f"encoder_{i}",
                    EncoderLayer(embed_dim, num_heads, dtype=dtype, device=device))
        self.query_decoder = _QueryDecoder(embed_dim, num_tokens, num_layers, num_heads,
                                           dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.cls_token, std=0.02, generator=generator)

    def forward(self, pcd: torch.Tensor) -> torch.Tensor:
        x = self.input_proj(pcd.to(self.dtype))
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"encoder_{i}")(x)
        return self.query_decoder(x[:, 0:1], x[:, 1:])


class DepthMapEncoder(nn.Module):
    """Depth map [B, H, W, 1] (channels-last) -> ``num_tokens`` conditioning tokens."""

    def __init__(self, in_channels: int = 1, embed_dim: int = 256, num_tokens: int = 64,
                 patch: int = 32, image_size: int = 512, num_layers: int = 8,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.patch_proj = PatchConv(in_channels, embed_dim, patch, dtype, device)
        g = image_size // patch
        pe = build_2d_sincos_position_embedding(g, g, embed_dim)
        self.register_buffer("pos_embed", torch.from_numpy(pe).to(device), persistent=False)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        for i in range(num_layers):
            setattr(self, f"mixer_{i}",
                    EncoderLayer(embed_dim, num_heads, dtype=dtype, device=device))
        self.query_decoder = _QueryDecoder(embed_dim, num_tokens, num_layers, num_heads,
                                           dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.cls_token, std=0.02, generator=generator)

    def forward(self, depth_maps: torch.Tensor) -> torch.Tensor:
        x = self.patch_proj(depth_maps)
        b, d = x.shape[0], x.shape[-1]
        x = x.reshape(b, -1, d) + self.pos_embed.to(self.dtype)[None]
        cls = self.cls_token.to(self.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"mixer_{i}")(x)
        return self.query_decoder(x[:, 0:1], x[:, 1:])
