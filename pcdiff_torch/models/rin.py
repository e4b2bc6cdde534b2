"""RIN-style two-stream denoiser backbone.

Counterpart of :mod:`pcdiff.models.rin`: an x-stream of point tokens exchanges
information with a z-stream of latent tokens through read/write cross-attentions, and the
quadratic self-attention runs on the latents only. ``ln_latent`` is zero-initialised, so
latent self-conditioning is a no-op at init, and the MLP over the previous latent sees it
detached (``lax.stop_gradient`` in the JAX package). The backbone's dropout rates are 0,
as the JAX package's are, so train mode changes nothing here. The RCW blocks run as a
Python loop: the JAX package's ``scan_blocks`` exists only to cut XLA compile time and has
no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .attention import CrossAttention, Dense, LayerNorm, Mlp
from .embeddings import timestep_embedding

__all__ = ["ComputeBlock", "ReadBlock", "WriteBlock", "RCWBlock", "DenoiserBackbone"]


class ComputeBlock(nn.Module):
    """Latent self-attention + MLP (reference ``Compute_Block``)."""

    def __init__(self, z_dim: int, num_heads: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attn = CrossAttention(z_dim, num_heads, qkv_bias, dtype=dtype, device=device)
        self.mlp = Mlp(z_dim, int(z_dim * mlp_ratio), dtype=dtype, device=device)
        self.norm_z1 = LayerNorm(z_dim, device=device)
        self.norm_z2 = LayerNorm(z_dim, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z + self.attn(z, z, q_ln=self.norm_z1, kv_ln=self.norm_z1)
        return z + self.mlp(z, ln=self.norm_z2)


class ReadBlock(nn.Module):
    """z <- cross-attend(x): pull information from the point stream."""

    def __init__(self, z_dim: int, x_dim: int, num_heads: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attn = CrossAttention(z_dim, num_heads, qkv_bias, kv_dim=x_dim, dtype=dtype,
                                   device=device)
        self.mlp = Mlp(z_dim, int(z_dim * mlp_ratio), dtype=dtype, device=device)
        self.norm_z1 = LayerNorm(z_dim, device=device)
        self.norm_x = LayerNorm(x_dim, device=device)
        self.norm_z2 = LayerNorm(z_dim, device=device)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        z = z + self.attn(z, x, q_ln=self.norm_z1, kv_ln=self.norm_x)
        return z + self.mlp(z, ln=self.norm_z2)


class WriteBlock(nn.Module):
    """x <- cross-attend(z): push computed features back to the points."""

    def __init__(self, x_dim: int, z_dim: int, num_heads: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attn = CrossAttention(x_dim, num_heads, qkv_bias, kv_dim=z_dim, dtype=dtype,
                                   device=device)
        self.mlp = Mlp(x_dim, int(x_dim * mlp_ratio), dtype=dtype, device=device)
        self.norm_x1 = LayerNorm(x_dim, device=device)
        self.norm_z = LayerNorm(z_dim, device=device)
        self.norm_x2 = LayerNorm(x_dim, device=device)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x, z, q_ln=self.norm_x1, kv_ln=self.norm_z)
        return x + self.mlp(x, ln=self.norm_x2)


class RCWBlock(nn.Module):
    """read -> K x compute -> write (reference ``RCW_Block``)."""

    def __init__(self, z_dim: int, x_dim: int, num_compute_layers: int = 4,
                 num_heads: int = 16, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        common = dict(num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      dtype=dtype, device=device)
        self.num_compute_layers = num_compute_layers
        self.read = ReadBlock(z_dim, x_dim, **common)
        for i in range(num_compute_layers):
            setattr(self, f"compute_{i}", ComputeBlock(z_dim, **common))
        self.write = WriteBlock(x_dim, z_dim, **common)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.read(z, x)
        for i in range(self.num_compute_layers):
            z = getattr(self, f"compute_{i}")(z)
        return z, self.write(z, x)


class DenoiserBackbone(nn.Module):
    """RIN denoiser over a point stream x and a latent stream z.

    z = [learned z_init | cond tokens | time token] + LN0(prev_latent +
    MLP(prev_latent)); then ``num_blocks`` RCW rounds; the final z is returned as the next
    call's self-conditioning latent.
    """

    def __init__(self, input_channels: int = 3, output_channels: int = 3, num_z: int = 256,
                 num_x: int = 4096, z_dim: int = 768, x_dim: int = 512, num_blocks: int = 6,
                 num_compute_layers: int = 4, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_z, self.num_x, self.z_dim = num_z, num_x, z_dim
        self.num_blocks = num_blocks
        self.dtype = dtype
        hidden = int(z_dim * mlp_ratio)
        self.time_embed = Mlp(z_dim, hidden, out_dim=z_dim, dtype=dtype, device=device)
        self.input_proj = Dense(input_channels, x_dim, True, dtype, device)
        self.ln_pre = LayerNorm(x_dim, dtype=dtype, device=device)
        self.z_init = nn.Parameter(torch.empty(1, num_z, z_dim, device=device))
        self.latent_mlp = Mlp(z_dim, hidden, dtype=dtype, device=device)
        self.ln_latent = LayerNorm(z_dim, dtype=dtype, zero_init=True, device=device)
        for i in range(num_blocks):
            setattr(self, f"block_{i}", RCWBlock(
                z_dim, x_dim, num_compute_layers, num_heads, mlp_ratio, qkv_bias,
                dtype, device))
        self.ln_post = LayerNorm(x_dim, dtype=dtype, device=device)
        self.output_proj = Dense(x_dim, output_channels, True, torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.z_init, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                prev_latent: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, num_x, C_in], t: [B], cond: [B, num_cond, z_dim], prev_latent:
        [B, num_z + num_cond + 1, z_dim] or None. Returns (x_denoised fp32, z)."""
        b, num_x, _ = x.shape
        if num_x != self.num_x:
            raise ValueError(f"expected {self.num_x} points, got {num_x}")
        num_latent = self.num_z + cond.shape[1] + 1
        if prev_latent is None:
            prev_latent = torch.zeros(b, num_latent, self.z_dim, dtype=self.dtype,
                                      device=x.device)
        if prev_latent.shape[1] != num_latent:
            raise ValueError(f"prev_latent has {prev_latent.shape[1]} tokens, "
                             f"expected {num_latent}")

        t_embed = self.time_embed(timestep_embedding(t, self.z_dim).to(self.dtype))[:, None]
        x = self.ln_pre(self.input_proj(x.to(self.dtype)))
        z = torch.cat([self.z_init.to(self.dtype).expand(b, -1, -1),
                       cond.to(self.dtype), t_embed], dim=1)
        prev_latent = prev_latent + self.latent_mlp(prev_latent.detach())
        z = z + self.ln_latent(prev_latent)
        for i in range(self.num_blocks):
            z, x = getattr(self, f"block_{i}")(z, x)
        return self.output_proj(self.ln_post(x)), z
