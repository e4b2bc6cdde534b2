"""Positional and timestep embeddings.

Counterpart of :mod:`pcdiff.models.embeddings` (the two tables the flagship sampler
uses). The 2D table is computed in numpy, as the JAX package does, and enters the model
as a constant.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["timestep_embedding", "build_2d_sincos_position_embedding"]


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embeddings of (possibly fractional) timesteps -> [N, dim] fp32, in the
    Point-E ``[cos | sin]`` order, zero-padded if dim is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def build_2d_sincos_position_embedding(
    h: int, w: int, dim: int, temperature: float = 10_000.0
) -> np.ndarray:
    """Fixed 2D sin-cos position embedding over an h x w grid -> [h*w, dim] float32, in
    the quadrant layout [sin_x | cos_x | sin_y | cos_y], each dim/4 wide."""
    if dim % 4:
        raise ValueError("dim must be divisible by 4 for the 2D sin-cos embedding")
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y = y.reshape(-1).astype(np.float64)
    x = x.reshape(-1).astype(np.float64)
    div = np.exp(
        np.arange(0, dim // 2, 2, dtype=np.float64) * -(math.log(temperature) / (dim // 4)))
    pe = np.zeros((h * w, dim), dtype=np.float32)
    pe[:, 0: dim // 4] = np.sin(x[:, None] * div)
    pe[:, dim // 4: dim // 2] = np.cos(x[:, None] * div)
    pe[:, dim // 2: 3 * dim // 4] = np.sin(y[:, None] * div)
    pe[:, 3 * dim // 4:] = np.cos(y[:, None] * div)
    return pe
