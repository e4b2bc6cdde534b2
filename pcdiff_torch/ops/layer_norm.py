"""Standalone LayerNorm over the last axis (plain PyTorch).

Counterpart of :func:`pcdiff.ops.layer_norm._xla_layer_norm`, the path the JAX package
runs by default on the TPU too (``_use_pallas_ln`` keeps XLA unless asked): fp32
statistics with the fast-variance formula ``max(0, E[x^2] - E[x]^2)`` (not torch's
two-pass variance), fp32 scale and bias, one cast to ``out_dtype``. The standalone Pallas
LayerNorm kernel is not on the sampler's path and is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, scale, bias, epsilon: float, out_dtype):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + epsilon) * scale.float()
    return ((x32 - mean) * mul + bias.float()).to(out_dtype)
