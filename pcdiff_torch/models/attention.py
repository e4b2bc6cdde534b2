"""Attention and transformer building blocks.

Counterpart of :mod:`pcdiff.models.attention`, in the graph the JAX package runs on the
TPU (``set_ln_dense_fusion`` on): every pre-LN that feeds projections is fused into them
through :func:`pcdiff_torch.ops.ln_dense.fused_ln_denses`, the attention's 1/sqrt(d) is
folded into ``wq`` and its bias, and every attention goes through
:func:`pcdiff_torch.ops.flash_attention.fused_attention_mh` with the heads folded in the
feature axis, unless its ``attention_fn`` hook is set to another function than
:func:`dot_product_attention`: then the heads are split to ``[B, H, N, D]`` for the hook
(:func:`pcdiff_torch.ops.flash_attention.fused_attention`, K7, is the port's own).
Parameters are fp32 in the ``nn.Linear`` layout; ``dtype`` is the activation dtype. Two
switches, both off by default as in the JAX package, select the fully fused configuration: :func:`set_ln_mlp_fusion` runs each pre-LN MLP whose dropout is
inactive as one kernel (:func:`pcdiff_torch.ops.ln_mlp.fused_ln_mlp`), and
:func:`pcdiff_torch.ops.layer_norm.set_layernorm_backend` sends every standalone
:class:`LayerNorm` to its kernel. ``module.train()`` turns on the dropout of the JAX
package's train mode (``deterministic=False``), with masks drawn from the generator that
:func:`dropout_generator` installs; ``eval()`` turns it off.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import fused_attention, fused_attention_mh
from ..ops.layer_norm import fused_layer_norm
from ..ops.ln_dense import fused_ln_denses
from ..ops.ln_mlp import fused_ln_mlp

__all__ = [
    "dot_product_attention",
    "Dense",
    "LayerNorm",
    "CrossAttention",
    "Mlp",
    "EncoderLayer",
    "DecoderLayer",
    "set_gelu_impl",
    "gelu_act",
    "set_ln_mlp_fusion",
    "fuse_ln_mlp_enabled",
    "dropout",
    "dropout_generator",
    "LN_EPS",
]

LN_EPS = 1e-5  # torch-parity epsilon, as pcdiff.models.attention.LN_EPS
# train-mode dropout of the encoder and decoder layers: every encoder of the JAX package
# builds them with the default drop=0.1 (pcdiff.models.encoders)
ENCODER_DROP = 0.1

_GELU_IMPL = "erf"  # erf | tanh

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with an fp32 softmax over ``[B, H, N, D]``; q pre-scaled. The default
    ``attention_fn`` of every attention: :class:`CrossAttention` recognises it and keeps the
    heads folded (K1) instead of calling it."""
    return fused_attention(q, k, v)


def set_gelu_impl(mode: str) -> None:
    """GELU of every MLP: 'erf' (exact, the default) or 'tanh' (torch approximate='tanh'),
    as :func:`pcdiff.models.attention.set_gelu_impl`. The literal exact GELUs of
    ``ViewAngleEmbedding`` do not follow it."""
    global _GELU_IMPL
    if mode not in ("erf", "tanh"):
        raise ValueError(f"unknown GELU mode {mode!r}")
    _GELU_IMPL = mode


def gelu_act() -> str:
    """The activation tag MLPs pass to the fused LN+Dense kernel."""
    return "gelu" if _GELU_IMPL == "erf" else "gelu_tanh"


_LN_MLP_FUSION = False


def set_ln_mlp_fusion(mode: str) -> None:
    """Whether each pre-LN MLP whose dropout is inactive runs LN -> fc1 -> act -> fc2 as one
    kernel (:func:`pcdiff_torch.ops.ln_mlp.fused_ln_mlp`): 'off' (the default, the split
    path: LN + fc1 fused, then fc2) or 'on', as :func:`pcdiff.models.attention.set_ln_mlp_fusion`.
    The port has only the fused LN+Dense graph, so the JAX package's 'auto' (which follows
    the LN+Dense fusion) means 'on' here. Parameters are the same either way."""
    global _LN_MLP_FUSION
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"unknown LN+MLP fusion mode {mode!r}")
    _LN_MLP_FUSION = mode != "off"


def fuse_ln_mlp_enabled() -> bool:
    return _LN_MLP_FUSION


_DROPOUT_GEN: Optional[torch.Generator] = None


@contextmanager
def dropout_generator(generator: torch.Generator) -> Iterator[torch.Generator]:
    """Draw every train-mode dropout and CFG-dropout mask inside the block from
    ``generator`` (on the activations' device)."""
    global _DROPOUT_GEN
    prev, _DROPOUT_GEN = _DROPOUT_GEN, generator
    try:
        yield generator
    finally:
        _DROPOUT_GEN = prev


def draw_uniform(shape, device) -> torch.Tensor:
    """U[0, 1) draws from the generator of :func:`dropout_generator`."""
    if _DROPOUT_GEN is None:
        raise RuntimeError("train-mode dropout draws from an explicit generator: run the "
                           "model inside pcdiff_torch.models.attention.dropout_generator(g)")
    return torch.rand(shape, generator=_DROPOUT_GEN, device=device)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and scale the kept
    ones by 1 / (1 - rate); the identity when not training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = draw_uniform(x.shape, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(t, -bound, bound, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x W^T + b`` computed in ``dtype``; W is fp32 ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        out_features, in_features = self.weight.shape
        _xavier_uniform_(self.weight, in_features, out_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """Last-axis LayerNorm with fp32 fast-variance statistics, eps 1e-5, output in
    ``dtype``. At a fused site the consumer reads ``weight``/``bias``/``eps`` and
    normalises inside its projection kernel instead of calling this module."""

    def __init__(self, dim: int, eps: float = LN_EPS, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.constant_(self.weight, 0.0 if self.zero_init else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


def _ln_dense_multi(x, ln: LayerNorm, layers, dtype, acts=None, out_scales=None):
    """LN(x) -> [act_i(Dense_i(LN(x)) * s_i)] through the fused kernel; ``out_scales``
    are constants folded into the weights and biases (fp32) before the call."""
    weights = [layer.weight for layer in layers]
    biases = [layer.bias for layer in layers]
    if out_scales is not None:
        weights = [w if s is None else w * s for w, s in zip(weights, out_scales)]
        biases = [b if (s is None or b is None) else b * s
                  for b, s in zip(biases, out_scales)]
    return fused_ln_denses(x, ln.weight, ln.bias, weights, biases, ln.eps, dtype, acts)


class CrossAttention(nn.Module):
    """Multi-head attention with separate query and key/value inputs, pre-LN fused into
    the projections (reference RIN ``CrossAttention``). Output dim = ``dim``. In train
    mode ``attn_drop`` drops the attention output before ``proj`` (the JAX package's
    stand-in for dropping the weights inside the fused kernel). The JAX module's
    ``proj_drop`` is left out: every caller there sets it to 0. ``attention_fn`` is the
    JAX module's hook: :func:`dot_product_attention` (the default) runs the folded-head
    kernel; any other function gets ``[B, H, N, D]`` heads and returns them so."""

    def __init__(self, dim: int, num_heads: int = 16, qkv_bias: bool = False,
                 q_dim: Optional[int] = None, kv_dim: Optional[int] = None,
                 attn_drop: float = 0.0, dtype: torch.dtype = torch.float32, device=None,
                 attention_fn: AttentionFn = dot_product_attention):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.dtype = dtype
        self.attention_fn = attention_fn
        q_dim = q_dim or dim
        kv_dim = kv_dim or dim
        self.wq = Dense(q_dim, dim, qkv_bias, dtype, device)
        self.wk = Dense(kv_dim, dim, qkv_bias, dtype, device)
        self.wv = Dense(kv_dim, dim, qkv_bias, dtype, device)
        self.proj = Dense(dim, dim, True, dtype, device)

    def _raw_kv(self, x_kv: torch.Tensor, layer: Dense) -> torch.Tensor:
        # un-normalised memory (decoder cross-attention): a plain matmul, then the bias
        out = x_kv.to(self.dtype) @ layer.weight.to(self.dtype).t()
        return out if layer.bias is None else out + layer.bias.to(self.dtype)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor, q_ln: LayerNorm,
                kv_ln: Optional[LayerNorm] = None) -> torch.Tensor:
        """``x_q``/``x_kv`` are un-normalised; ``q_ln``/``kv_ln`` are the pre-LNs fused into
        the projections (``kv_ln=None``: the kv side is projected as it is)."""
        scale = (self.dim // self.num_heads) ** -0.5
        if x_q is x_kv and q_ln is kv_ln:
            q2, k2, v2 = _ln_dense_multi(x_q, q_ln, [self.wq, self.wk, self.wv], self.dtype,
                                         out_scales=[scale, None, None])
        else:
            (q2,) = _ln_dense_multi(x_q, q_ln, [self.wq], self.dtype, out_scales=[scale])
            if kv_ln is not None:
                k2, v2 = _ln_dense_multi(x_kv, kv_ln, [self.wk, self.wv], self.dtype)
            else:
                k2, v2 = self._raw_kv(x_kv, self.wk), self._raw_kv(x_kv, self.wv)
        if self.attention_fn is dot_product_attention:
            # the default: heads stay folded in the feature axis, no head-split relayout
            out = fused_attention_mh(q2, k2, v2, self.num_heads)
        else:
            out = self.attention_fn(*(self._split_heads(t) for t in (q2, k2, v2)))
            out = out.transpose(1, 2).reshape(q2.shape)
        return self.proj(dropout(out, self.attn_drop, self.training))

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[B, N, H*D] -> a [B, H, N, D] view."""
        b, n, _ = t.shape
        return t.reshape(b, n, self.num_heads, self.dim // self.num_heads).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> GELU -> drop -> fc2 -> drop. With ``ln``, the pre-LN and the GELU are fused
    into fc1; with ``ln``, :func:`set_ln_mlp_fusion` on and the dropout inactive (eval mode
    or rate 0), the whole MLP is one kernel."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_dim, hidden_dim, True, dtype, device)
        self.fc2 = Dense(hidden_dim, out_dim or in_dim, True, dtype, device)

    def forward(self, x: torch.Tensor, ln: Optional[LayerNorm] = None) -> torch.Tensor:
        if ln is not None and fuse_ln_mlp_enabled() and (not self.training or self.drop == 0):
            return fused_ln_mlp(x, ln.weight, ln.bias, self.fc1.weight, self.fc1.bias,
                                self.fc2.weight, self.fc2.bias, ln.eps, self.fc1.dtype,
                                gelu_act())
        if ln is not None:
            (h,) = _ln_dense_multi(x, ln, [self.fc1], self.fc1.dtype, acts=[gelu_act()])
        else:
            h = F.gelu(self.fc1(x), approximate="tanh" if _GELU_IMPL == "tanh" else "none")
        h = dropout(h, self.drop, self.training)
        return dropout(self.fc2(h), self.drop, self.training)


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer (torch ``norm_first=True``): x += drop(attn(LN(x)));
    x += mlp(LN(x)), with :data:`ENCODER_DROP` also inside the attention and the MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.self_attn = CrossAttention(dim, num_heads, qkv_bias=True, attn_drop=ENCODER_DROP,
                                        dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=ENCODER_DROP, dtype=dtype,
                       device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.self_attn(x, x, q_ln=self.norm1, kv_ln=self.norm1)
        x = x + dropout(h, ENCODER_DROP, self.training)
        return x + self.mlp(x, ln=self.norm2)


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: self-attention over the queries, cross-attention to the
    (un-normalised) memory, then the MLP (torch ``TransformerDecoderLayer(norm_first)``),
    with :data:`ENCODER_DROP` on both attention residuals and inside the attentions and
    the MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.self_attn = CrossAttention(dim, num_heads, qkv_bias=True, attn_drop=ENCODER_DROP,
                                        dtype=dtype, device=device)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias=True,
                                         attn_drop=ENCODER_DROP, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=ENCODER_DROP, dtype=dtype,
                       device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)

    def forward(self, q: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        h = self.self_attn(q, q, q_ln=self.norm1, kv_ln=self.norm1)
        q = q + dropout(h, ENCODER_DROP, self.training)
        h = self.cross_attn(q, memory, q_ln=self.norm2, kv_ln=None)
        q = q + dropout(h, ENCODER_DROP, self.training)
        return q + self.mlp(q, ln=self.norm3)
