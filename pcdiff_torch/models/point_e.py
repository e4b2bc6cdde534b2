"""The Point-E denoisers: a ViT-style transformer over point tokens, with the time step,
a CLIP vector, a CLIP token grid or low-resolution points as conditioning.

Counterpart of :mod:`pcdiff.models.point_e`, in the graph the JAX package runs on the TPU
(``set_ln_dense_fusion`` on): every block's pre-LN is fused into its qkv projection and into
the MLP's fc1 (:func:`pcdiff_torch.ops.ln_dense.fused_ln_denses`, K3), and the attention
runs with the heads folded in the feature axis
(:func:`pcdiff_torch.ops.flash_attention.fused_attention_mh`, K1). The attention's and the
MLP's output projections and the embeddings are plain products (``Dense``), as the JAX
package computes them outside any Pallas kernel; the standalone LayerNorms are
:class:`pcdiff_torch.models.attention.LayerNorm`.

Numerically load-bearing details kept from the JAX modules:

- ``c_qkv`` interleaves q, k and v per head (``[H, 3, ch]`` output order); the fused path
  splits it into head-major q, k and v panels (:func:`qkv_panels`);
- split scaling: q and k each scaled by ``ch ** -0.25`` in the reference, folded into the
  q panel and its bias as ``1 / sqrt(ch)``;
- conditioning tokens prepended in each class's order and stripped after ``ln_post``:
  CLIP vector: [clip, time]; grid: [time, grid]; grid upsampler: [time, grid, low-res];
- the CLIP vector rescaled by ``sqrt(dim)``, the upsampler's ``channel_scales`` and
  ``channel_biases`` on the low-resolution points, a zero grid when no embeddings are given;
- ``output_proj`` in fp32, zero-initialised.

Parameters are fp32 in the ``nn.Linear`` layout, named as the flax tree
(``backbone.resblock_0.attn.c_qkv.weight``, ...), so
:func:`pcdiff_torch.core.params_from_flax` fills them one to one; ``dtype`` is the
activation dtype. Layout: points channels-last ``[B, N, C]``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import fused_attention_mh
from ..ops.ln_dense import fused_ln_denses
from ..ops.ln_mlp import fused_ln_mlp
from .attention import Dense, LayerNorm, fuse_ln_mlp_enabled, gelu_act
from .embeddings import timestep_embedding

__all__ = [
    "PointEAttention",
    "PointEMLP",
    "ResidualAttentionBlock",
    "PointETransformer",
    "PointDiffusionTransformer",
    "CLIPImagePointDiffusionTransformer",
    "CLIPImageGridPointDiffusionTransformer",
    "UpsamplePointDiffusionTransformer",
    "CLIPImageGridUpsamplePointDiffusionTransformer",
    "qkv_panels",
]


def _normal_(t: torch.Tensor, std: float, generator) -> None:
    nn.init.normal_(t, 0.0, std, generator=generator)


class _PointEDense(Dense):
    """``Dense`` with the JAX module's normal(std) kernel init (zero bias, or a zero
    kernel where ``std`` is 0: the zero-initialised output projections)."""

    def __init__(self, in_features: int, out_features: int, std: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, True, dtype, device)
        self.std = std

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.std:
            _normal_(self.weight, self.std, generator)
        else:
            nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


def qkv_panels(weight: torch.Tensor, bias: torch.Tensor, heads: int, parts: int,
               scales: Sequence[Optional[float]], interleaved: bool = True):
    """A fused projection's outputs as ``parts`` head-major panels: a list of (weight
    ``[H ch, C]``, bias ``[H ch]``) pairs, each times its scale where one is given. With
    ``interleaved`` the outputs interleave the parts per head (``[H, parts, ch]``: Point-E's
    ``c_qkv`` and the perceiver's ``c_kv``), else they are contiguous (``[parts, H ch]``:
    CLIP's ``in_proj``)."""
    out_f, c = weight.shape
    ch = out_f // (heads * parts)
    if interleaved:
        w4, b4 = weight.reshape(heads, parts, ch, c), bias.reshape(heads, parts, ch)
        pieces = [(w4[:, i].reshape(heads * ch, c), b4[:, i].reshape(heads * ch))
                  for i in range(parts)]
    else:
        pieces = list(zip(weight.reshape(parts, heads * ch, c), bias.reshape(parts, heads * ch)))
    panels = []
    for (w, b), s in zip(pieces, scales):
        if s is not None:
            w, b = w * s, b * s
        panels.append((w.contiguous(), b.contiguous()))
    return panels


class _Panels:
    """The panels of a fused projection (:func:`qkv_panels`), kept while its parameters are
    unchanged (their storage and version counters), so a sampler's calls split and scale
    them once. Under autograd they are split every call, through the graph."""

    def __init__(self, heads: int, parts: int, scales, interleaved: bool = True):
        self._args = (heads, parts, scales, interleaved)
        self._key = None
        self._panels = None

    def get(self, layer: Dense):
        w, b = layer.weight, layer.bias
        if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
            return qkv_panels(w, b, *self._args)
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, w.device)
        if key != self._key:
            with torch.no_grad():
                self._panels = qkv_panels(w, b, *self._args)
            self._key = key
        return self._panels


class PointEAttention(nn.Module):
    """Fused-qkv self-attention with split scaling; the pre-LN fused into the qkv
    projection."""

    def __init__(self, width: int, heads: int, init_scale: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.c_qkv = _PointEDense(width, 3 * width, init_scale, dtype, device)
        self.c_proj = _PointEDense(width, width, init_scale, dtype, device)
        self._panels = _Panels(heads, 3, [1.0 / math.sqrt(width // heads), None, None])

    def forward(self, x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
        """``x`` un-normalised; ``ln`` the pre-LN fused into the projection."""
        panels = self._panels.get(self.c_qkv)
        q, k, v = fused_ln_denses(x, ln.weight, ln.bias, [w for w, _ in panels],
                                  [b for _, b in panels], ln.eps, self.dtype)
        return self.c_proj(fused_attention_mh(q, k, v, self.heads))


class PointEMLP(nn.Module):
    """c_fc -> GELU -> c_proj; with ``ln`` the pre-LN and the GELU are fused into c_fc (or,
    under :func:`pcdiff_torch.models.set_ln_mlp_fusion`, the whole MLP is one call)."""

    def __init__(self, width: int, init_scale: float, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.c_fc = _PointEDense(width, 4 * width, init_scale, dtype, device)
        self.c_proj = _PointEDense(4 * width, width, init_scale, dtype, device)

    def forward(self, x: torch.Tensor, ln: Optional[LayerNorm] = None) -> torch.Tensor:
        if ln is not None and fuse_ln_mlp_enabled():
            return fused_ln_mlp(x, ln.weight, ln.bias, self.c_fc.weight, self.c_fc.bias,
                                self.c_proj.weight, self.c_proj.bias, ln.eps, self.dtype,
                                gelu_act())
        if ln is not None:
            (h,) = fused_ln_denses(x, ln.weight, ln.bias, [self.c_fc.weight], [self.c_fc.bias],
                                   ln.eps, self.dtype, [gelu_act()])
        else:
            h = F.gelu(self.c_fc(x), approximate="none" if gelu_act() == "gelu" else "tanh")
        return self.c_proj(h)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype=dtype, device=device)
        self.attn = PointEAttention(width, heads, init_scale, dtype, device)
        self.ln_2 = LayerNorm(width, dtype=dtype, device=device)
        self.mlp = PointEMLP(width, init_scale, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x, self.ln_1)
        return x + self.mlp(x, self.ln_2)


class PointETransformer(nn.Module):
    """``layers`` residual attention blocks; init scale ``init_scale / sqrt(width)``."""

    def __init__(self, width: int, layers: int, heads: int, init_scale: float = 0.25,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layers = layers
        scale = init_scale * math.sqrt(1.0 / width)
        for i in range(layers):
            setattr(self, f"resblock_{i}",
                    ResidualAttentionBlock(width, heads, scale, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        return x


class PointDiffusionTransformer(nn.Module):
    """The base Point-E denoiser: point tokens, the time step as a token or added."""

    def __init__(self, input_channels: int = 3, output_channels: int = 3, n_ctx: int = 1024,
                 width: int = 512, layers: int = 12, heads: int = 8, init_scale: float = 0.25,
                 time_token_cond: bool = False, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.input_channels, self.output_channels = input_channels, output_channels
        self.n_ctx, self.width, self.dtype = n_ctx, width, dtype
        self.time_token_cond = time_token_cond
        std = init_scale * math.sqrt(1.0 / width)
        self.time_embed = PointEMLP(width, std, dtype, device)
        self.input_proj = _PointEDense(input_channels, width, std, dtype, device)
        self.ln_pre = LayerNorm(width, dtype=dtype, device=device)
        self.backbone = PointETransformer(width, layers, heads, init_scale, dtype, device)
        self.ln_post = LayerNorm(width, dtype=dtype, device=device)
        self.output_proj = _PointEDense(width, output_channels, 0.0, torch.float32, device)
        self._std = std
        self.eval()

    def _time(self, t: torch.Tensor) -> torch.Tensor:
        return self.time_embed(timestep_embedding(t, self.width).to(self.dtype))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return self._forward_with_cond(x, [(self._time(t), self.time_token_cond)])

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[1] != self.n_ctx:
            raise ValueError(f"expected {self.n_ctx} points, got x {tuple(x.shape)}")

    def _forward_with_cond(self, x: torch.Tensor, cond_as_token) -> torch.Tensor:
        h = self.input_proj(x)
        for emb, as_token in cond_as_token:
            if not as_token:
                h = h + emb[:, None]
        extra = [(emb[:, None] if emb.dim() == 2 else emb)
                 for emb, as_token in cond_as_token if as_token]
        n_extra = sum(e.shape[1] for e in extra)
        if extra:
            h = torch.cat([e.to(h.dtype) for e in extra] + [h], dim=1)
        h = self.ln_pre(h)
        h = self.backbone(h)
        h = self.ln_post(h)
        if extra:
            h = h[:, n_extra:]
        return self.output_proj(h)

    def _cond_dropout(self, emb: torch.Tensor, cond_drop_prob: float) -> torch.Tensor:
        """Train-mode conditioning dropout, as the JAX module's: each row zeroed with
        probability ``cond_drop_prob``, from the generator of
        :func:`pcdiff_torch.models.attention.dropout_generator`."""
        if not self.training or cond_drop_prob <= 0.0:
            return emb
        from .attention import draw_uniform

        keep = draw_uniform((emb.shape[0],), emb.device) >= cond_drop_prob
        return emb * keep.reshape((-1,) + (1,) * (emb.dim() - 1)).to(emb.dtype)


class CLIPImagePointDiffusionTransformer(PointDiffusionTransformer):
    """Conditioned on one CLIP vector (a text or an image embedding)."""

    def __init__(self, *, token_cond: bool = False, cond_drop_prob: float = 0.0,
                 clip_feature_dim: int = 768, **kwargs):
        super().__init__(**kwargs)
        self.token_cond, self.cond_drop_prob = token_cond, cond_drop_prob
        self.clip_embed = _PointEDense(clip_feature_dim, self.width, self._std, self.dtype,
                                       self.input_proj.weight.device)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._check(x)
        if embeddings is None:
            raise ValueError("pass precomputed CLIP embeddings")
        t_embed = self._time(t)
        clip_out = self._cond_dropout(embeddings, self.cond_drop_prob)
        clip_out = math.sqrt(clip_out.shape[1]) * clip_out  # unit-variance features
        clip_embed = self.clip_embed(clip_out)
        return self._forward_with_cond(
            x, [(clip_embed, self.token_cond), (t_embed, self.time_token_cond)])


class _GridEmbed:
    """The CLIP token grid's LayerNorm and projection (a mixin of the grid classes)."""

    def _init_grid(self, grid_size: int, grid_feature_dim: int, cond_drop_prob: float):
        dev = self.input_proj.weight.device
        self.grid_size, self.grid_feature_dim = grid_size, grid_feature_dim
        self.cond_drop_prob = cond_drop_prob
        self.clip_embed_ln = LayerNorm(grid_feature_dim, dtype=self.dtype, device=dev)
        self.clip_embed = _PointEDense(grid_feature_dim, self.width, self._std, self.dtype,
                                       dev)

    def _grid(self, embeddings: torch.Tensor) -> torch.Tensor:
        clip_out = self._cond_dropout(embeddings, self.cond_drop_prob)
        return self.clip_embed(self.clip_embed_ln(clip_out.to(self.dtype)))


class CLIPImageGridPointDiffusionTransformer(_GridEmbed, PointDiffusionTransformer):
    """Conditioned on the CLIP ViT token grid ``[B, L, D]`` (channels-last)."""

    def __init__(self, *, cond_drop_prob: float = 0.0, grid_size: int = 16,
                 grid_feature_dim: int = 1024, **kwargs):
        PointDiffusionTransformer.__init__(self, **kwargs)
        self._init_grid(grid_size, grid_feature_dim, cond_drop_prob)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._check(x)
        if embeddings is None:
            raise ValueError("pass precomputed CLIP grid embeddings")
        t_embed = self._time(t)
        return self._forward_with_cond(
            x, [(t_embed, self.time_token_cond), (self._grid(embeddings), True)])


class UpsamplePointDiffusionTransformer(PointDiffusionTransformer):
    """The upsampler: denoises ``n_ctx`` new points given ``low_res`` points."""

    def __init__(self, *, cond_input_channels: Optional[int] = None, cond_ctx: int = 1024,
                 channel_scales: Optional[Sequence[float]] = None,
                 channel_biases: Optional[Sequence[float]] = None, **kwargs):
        super().__init__(**kwargs)
        self.cond_ctx = cond_ctx
        self.channel_scales = None if channel_scales is None else tuple(channel_scales)
        self.channel_biases = None if channel_biases is None else tuple(channel_biases)
        cin = cond_input_channels or self.input_channels
        self.cond_point_proj = _PointEDense(cin, self.width, self._std, self.dtype,
                                            self.input_proj.weight.device)

    def _embed_low_res(self, low_res: torch.Tensor) -> torch.Tensor:
        x = low_res
        if self.channel_scales is not None:
            x = x * torch.tensor(self.channel_scales, dtype=x.dtype, device=x.device)
        if self.channel_biases is not None:
            x = x + torch.tensor(self.channel_biases, dtype=x.dtype, device=x.device)
        return self.cond_point_proj(x)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                low_res: torch.Tensor) -> torch.Tensor:
        self._check(x)
        t_embed = self._time(t)
        return self._forward_with_cond(
            x, [(t_embed, self.time_token_cond), (self._embed_low_res(low_res), True)])


class CLIPImageGridUpsamplePointDiffusionTransformer(_GridEmbed,
                                                     UpsamplePointDiffusionTransformer):
    """The upsampler also conditioned on a CLIP token grid (zeros when none is given)."""

    def __init__(self, *, cond_drop_prob: float = 0.0, grid_size: int = 16,
                 grid_feature_dim: int = 1024, **kwargs):
        UpsamplePointDiffusionTransformer.__init__(self, **kwargs)
        self._init_grid(grid_size, grid_feature_dim, cond_drop_prob)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, low_res: torch.Tensor,
                embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._check(x)
        t_embed = self._time(t)
        low_res_embed = self._embed_low_res(low_res)
        if embeddings is None:  # unconditional generation
            embeddings = torch.zeros((x.shape[0], self.grid_size ** 2, self.grid_feature_dim),
                                     dtype=x.dtype, device=x.device)
        return self._forward_with_cond(
            x, [(t_embed, self.time_token_cond), (self._grid(embeddings), True),
                (low_res_embed, True)])
