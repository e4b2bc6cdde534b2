"""SimplePerceiver: a cross-attention-only stack, where queries attend to data again and
again (the SDF model's decoder).

Counterpart of :mod:`pcdiff.models.perceiver`, in the fused graph: the pre-LNs of the
queries and of the data are fused into ``c_q`` and ``c_kv`` (K3), whose ``c_kv`` interleaves
k and v per head (``[H, 2, ch]``) and is split into head-major panels, the split scaling
folded into ``c_q`` as ``1 / sqrt(ch)``; the attention runs with the heads folded (K1);
``c_proj`` and the MLP's ``c_proj`` are plain products. Parameters are named as the flax tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.flash_attention import fused_attention_mh
from ..ops.ln_dense import fused_ln_denses
from .attention import LayerNorm
from .point_e import PointEMLP, _Panels, _PointEDense

__all__ = ["MultiheadCrossAttention", "ResidualCrossAttentionBlock", "SimplePerceiver"]


class MultiheadCrossAttention(nn.Module):
    def __init__(self, width: int, heads: int, init_scale: float,
                 data_width: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.c_q = _PointEDense(width, width, init_scale, dtype, device)
        self.c_kv = _PointEDense(data_width or width, 2 * width, init_scale, dtype, device)
        self.c_proj = _PointEDense(width, width, init_scale, dtype, device)
        self._q_panel = _Panels(heads, 1, [1.0 / math.sqrt(width // heads)])
        self._panels = _Panels(heads, 2, [None, None])

    def forward(self, x: torch.Tensor, data: torch.Tensor, q_ln: LayerNorm,
                kv_ln: LayerNorm) -> torch.Tensor:
        """``x`` and ``data`` un-normalised; ``q_ln``/``kv_ln`` fused into the projections."""
        ((wq, bq),) = self._q_panel.get(self.c_q)
        (q,) = fused_ln_denses(x, q_ln.weight, q_ln.bias, [wq], [bq], q_ln.eps, self.dtype)
        panels = self._panels.get(self.c_kv)
        k, v = fused_ln_denses(data, kv_ln.weight, kv_ln.bias, [w for w, _ in panels],
                               [b for _, b in panels], kv_ln.eps, self.dtype)
        return self.c_proj(fused_attention_mh(q, k, v, self.heads))


class ResidualCrossAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, init_scale: float = 1.0,
                 data_width: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(data_width or width, dtype=dtype, device=device)
        self.attn = MultiheadCrossAttention(width, heads, init_scale, data_width, dtype, device)
        self.ln_3 = LayerNorm(width, dtype=dtype, device=device)
        self.mlp = PointEMLP(width, init_scale, dtype, device)

    def forward(self, x: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x, data, self.ln_1, self.ln_2)
        return x + self.mlp(x, self.ln_3)


class SimplePerceiver(nn.Module):
    """``layers`` cross-attention blocks; init scale ``init_scale / sqrt(width)``."""

    def __init__(self, width: int, layers: int, heads: int, init_scale: float = 0.25,
                 data_width: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.layers = layers
        scale = init_scale * math.sqrt(1.0 / width)
        for i in range(layers):
            setattr(self, f"resblock_{i}", ResidualCrossAttentionBlock(
                width, heads, scale, data_width, dtype, device))

    def forward(self, x: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, data)
        return x
