"""Rotary-position partial-cloud encoder (an alternative encoder; no caller builds it).

Counterpart of :mod:`pcdiff.models.rotary`: a 3-D rotary position embedding that rotates
the first 6 head dims (three axis pairs) of q and k by xyz * pi, a rotary transformer over
the points, learned queries that extract the tokens, and a rotary refiner over them. The
JAX module's quirks are kept:

- the self-attention's scale is ``dim ** -0.5``, not the head dim's;
- the refiner's positions are the first ``num_tokens`` points, ``pcd[:, :num_tokens]``;
- the stem's two GELUs are exact, whatever :func:`~pcdiff_torch.models.set_gelu_impl` says;
- the query stage is a cross-attention from the queries to the encoded points.

Kernel routing is the JAX graph's: ``decoder_attn`` is :class:`CrossAttention` without a
fused pre-LN (dense projections, then the folded-head attention kernel K1 at head dim
``embed_dim / num_heads``); the LayerNorms are :class:`LayerNorm` (the standalone
LayerNorm kernel K6a under ``set_layernorm_backend("kernel")``); the rotary
self-attention is plain ``torch.matmul`` and softmax, as the JAX package computes it
outside any Pallas kernel. Submodules carry the flax tree's names, so
:func:`~pcdiff_torch.core.params_from_flax` maps the JAX parameters one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import CrossAttention, Dense, LayerNorm, Mlp, _xavier_uniform_, dropout

__all__ = ["apply_rotary_pos_emb", "RotarySelfAttention", "RotaryTransformerLayer",
           "RotaryPartialPointCloudEncoder"]


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, coords: torch.Tensor):
    """Rotate the first 6 head dims (3 axis pairs) of q and k [B, H, N, D] by xyz * pi of
    ``coords`` [B, N, 3]. The rotated dims come out in the promoted dtype of q and the
    coordinates (fp32 for a bf16 q), as jnp's promotion gives them."""
    theta = coords * math.pi
    sin, cos = torch.sin(theta)[:, None], torch.cos(theta)[:, None]  # [B, 1, N, 3]

    def rotate(x):
        x1, x2 = x[..., 0:6:2], x[..., 1:6:2]
        rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return torch.cat([rotated, x[..., 6:].to(rotated.dtype)], dim=-1)

    return rotate(q), rotate(k)


class RotarySelfAttention(nn.Module):
    """Multi-head self-attention with rotary positions; fp32 logits and softmax, the
    weights in the input's dtype."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim, self.heads, self.drop, self.dtype = dim, heads, dropout, dtype
        self.qkv = Dense(dim, dim * 3, True, dtype, device)
        self.out_proj = Dense(dim, dim, True, dtype, device)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        dh = d // h
        assert dh >= 6 and dh % 2 == 0, "head dim must be even and >= 6 for RoPE"
        scale = d ** -0.5  # the JAX module's (and the reference's) scale: dim, not head dim
        qkv = self.qkv(x).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k = apply_rotary_pos_emb(qkv[0], qkv[1], pos)
        v = qkv[2]
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        w = dropout(w, self.drop, self.training)
        out = torch.matmul(w, v.to(w.dtype)).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class RotaryTransformerLayer(nn.Module):
    """Pre-LN layer: x += attn(LN(x), pos); x += mlp(LN(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = RotarySelfAttention(dim, heads, dropout, dtype, device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=dropout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class RotaryPartialPointCloudEncoder(nn.Module):
    """Partial cloud [B, N, 3] -> [B, num_tokens, embed_dim] with rotary positions
    (N >= num_tokens)."""

    def __init__(self, input_dim: int = 3, embed_dim: int = 256, num_tokens: int = 256,
                 num_layers: int = 6, num_heads: int = 8, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        self.in_fc1 = Dense(input_dim, embed_dim // 2, True, dtype, device)
        self.in_fc2 = Dense(embed_dim // 2, embed_dim, True, dtype, device)
        for i in range(num_layers):
            setattr(self, f"encoder_{i}", RotaryTransformerLayer(
                embed_dim, num_heads, dropout=dropout, dtype=dtype, device=device))
        self.token_queries = nn.Parameter(torch.empty(1, num_tokens, embed_dim, device=device))
        self.decoder_attn = CrossAttention(embed_dim, num_heads, qkv_bias=True, dtype=dtype,
                                           device=device)
        for i in range(num_layers // 2):
            setattr(self, f"refiner_{i}", RotaryTransformerLayer(
                embed_dim, num_heads, dropout=dropout, dtype=dtype, device=device))
        self.token_proj = Dense(embed_dim, embed_dim, True, dtype, device)
        self.ln_output = LayerNorm(embed_dim, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, n, d = self.token_queries.shape
        _xavier_uniform_(self.token_queries, n, d, generator)

    def forward(self, pcd: torch.Tensor) -> torch.Tensor:
        b = pcd.shape[0]
        x = F.gelu(self.in_fc2(F.gelu(self.in_fc1(pcd.to(self.dtype)))))
        for i in range(self.num_layers):
            x = getattr(self, f"encoder_{i}")(x, pcd)
        tokens = self.token_queries.to(self.dtype).expand(b, -1, -1)
        tokens = self.decoder_attn(tokens, x)
        for i in range(self.num_layers // 2):
            tokens = getattr(self, f"refiner_{i}")(tokens, pcd[:, :self.num_tokens])
        return self.ln_output(self.token_proj(tokens))
