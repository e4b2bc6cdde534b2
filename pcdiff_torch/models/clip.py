"""CLIP (ViT-L/14 or ViT-B/32) for Point-E's conditioning: the vision tower (the image
embedding, or the token grid base40M and the upsampler read) and the text tower.

Counterpart of :mod:`pcdiff.models.clip`, in the fused graph: each block's ``ln_1`` is fused
into ``in_proj`` (contiguous thirds q, k, v; ``Dh ** -0.5`` folded into the q panel and its
bias) and ``ln_2`` into ``c_fc`` with its quick-GELU epilogue (K3); the vision tower's
unmasked attention runs with the heads folded (K1); the text tower's causal attention is
plain products with an fp32 softmax, as the JAX package computes it with ``einsum``; the
output projections and ``c_proj`` are plain products. Parameters are named as the flax tree
(``visual.block_0.attn.in_proj.weight``, ...), so :func:`pcdiff_torch.core.params_from_flax`
fills them; :func:`import_clip_torch_state` takes an OpenAI CLIP ``state_dict``.

Image preprocessing (:func:`preprocess_image`) is the JAX package's numpy helper; text goes
through :class:`pcdiff_torch.tokenizer.SimpleTokenizer`, which needs CLIP's BPE merges file,
or as token ids.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import fused_attention_mh
from ..ops.ln_dense import fused_ln_denses
from .attention import Dense, LayerNorm
from .encoders import Embed, PatchConv
from .point_e import _Panels

__all__ = [
    "CLIPConfig",
    "CLIP_CONFIGS",
    "CLIPTextTower",
    "CLIPVisionTower",
    "CLIPModel",
    "ImageCLIP",
    "import_clip_torch_state",
    "preprocess_image",
]


class CLIPConfig:
    def __init__(self, *, embed_dim, image_resolution, vision_width, vision_layers,
                 vision_patch, text_width, text_layers, text_heads, vocab_size=49408,
                 context_length=77, vision_heads=None):
        self.embed_dim = embed_dim
        self.image_resolution = image_resolution
        self.vision_width = vision_width
        self.vision_layers = vision_layers
        self.vision_patch = vision_patch
        self.vision_heads = vision_heads or vision_width // 64
        self.text_width = text_width
        self.text_layers = text_layers
        self.text_heads = text_heads
        self.vocab_size = vocab_size
        self.context_length = context_length

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch


CLIP_CONFIGS = {
    "ViT-L/14": CLIPConfig(
        embed_dim=768, image_resolution=224, vision_width=1024, vision_layers=24,
        vision_patch=14, text_width=768, text_layers=12, text_heads=12,
    ),
    "ViT-B/32": CLIPConfig(
        embed_dim=512, image_resolution=224, vision_width=768, vision_layers=12,
        vision_patch=32, text_width=512, text_layers=12, text_heads=8,
    ),
}


class _CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.in_proj = Dense(width, 3 * width, True, dtype, device)
        self.out_proj = Dense(width, width, True, dtype, device)
        self._panels = _Panels(heads, 3, [(width // heads) ** -0.5, None, None],
                               interleaved=False)

    def forward(self, x: torch.Tensor, ln: LayerNorm,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` un-normalised, ``ln`` fused into ``in_proj``; ``mask`` an additive
        ``[N, N]`` fp32 mask (the text tower's causal one) or None."""
        panels = self._panels.get(self.in_proj)
        q, k, v = fused_ln_denses(x, ln.weight, ln.bias, [w for w, _ in panels],
                                  [b for _, b in panels], ln.eps, self.dtype)
        if mask is None:
            out = fused_attention_mh(q, k, v, self.heads)
        else:
            b, n, _ = x.shape
            qh, kh, vh = (t.reshape(b, n, self.heads, -1).transpose(1, 2) for t in (q, k, v))
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) + mask
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.matmul(w, vh.to(x.dtype)).transpose(1, 2).reshape(b, n, self.width)
        return self.out_proj(out)


class _CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(width, dtype=dtype, device=device)
        self.attn = _CLIPAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm(width, dtype=dtype, device=device)
        self.c_fc = Dense(width, 4 * width, True, dtype, device)
        self.c_proj = Dense(4 * width, width, True, dtype, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(x, self.ln_1, mask)
        (h,) = fused_ln_denses(x, self.ln_2.weight, self.ln_2.bias, [self.c_fc.weight],
                               [self.c_fc.bias], self.ln_2.eps, self.dtype, ["quick_gelu"])
        return x + self.c_proj(h)


class CLIPVisionTower(nn.Module):
    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        c, self.config, self.dtype = config, config, dtype
        w = c.vision_width
        self.conv1 = PatchConv(3, w, c.vision_patch, dtype, device, use_bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(c.grid_size ** 2 + 1, w, device=device))
        self.ln_pre = LayerNorm(w, dtype=dtype, device=device)
        for i in range(c.vision_layers):
            setattr(self, f"block_{i}", _CLIPBlock(w, c.vision_heads, dtype, device))
        self.ln_post = LayerNorm(w, dtype=dtype, device=device)
        self.proj = nn.Parameter(torch.empty(w, c.embed_dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.config.vision_width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            nn.init.normal_(p, 0.0, std, generator=generator)

    def forward(self, pixels: torch.Tensor, return_grid: bool = False) -> torch.Tensor:
        """``pixels [B, H, W, 3]`` preprocessed -> the ``[B, embed_dim]`` embedding, or with
        ``return_grid`` the ``[B, grid ** 2, width]`` fp32 token grid after the blocks and
        before ``ln_post``, without the class token."""
        c = self.config
        b = pixels.shape[0]
        x = self.conv1(pixels).reshape(b, -1, c.vision_width)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c.vision_width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)[None]
        x = self.ln_pre(x)
        for i in range(c.vision_layers):
            x = getattr(self, f"block_{i}")(x)
        if return_grid:
            return x[:, 1:, :].float()
        return self.ln_post(x[:, 0, :]) @ self.proj.to(self.dtype)


class CLIPTextTower(nn.Module):
    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        c, self.config, self.dtype = config, config, dtype
        self.token_embedding = Embed(c.vocab_size, c.text_width, 0.02, dtype, device)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.text_width, device=device))
        for i in range(c.text_layers):
            setattr(self, f"block_{i}", _CLIPBlock(c.text_width, c.text_heads, dtype, device))
        self.ln_final = LayerNorm(c.text_width, dtype=dtype, device=device)
        self.text_projection = nn.Parameter(
            torch.empty(c.text_width, c.embed_dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.positional_embedding, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.text_projection, 0.0, self.config.text_width ** -0.5,
                        generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [B, context_length]`` -> ``[B, embed_dim]``, pooled at the EOT token (the
        highest id of each row)."""
        x = self.token_embedding(tokens)
        n = x.shape[1]
        x = x + self.positional_embedding.to(self.dtype)[None, :n]
        mask = torch.triu(torch.full((n, n), float("-inf"), device=x.device), diagonal=1)
        for i in range(self.config.text_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection.to(self.dtype)


class CLIPModel(nn.Module):
    """Both towers and ``logit_scale``; on the card unless ``device="cpu"``."""

    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.config = config
        self.visual = CLIPVisionTower(config, dtype, device)
        self.text = CLIPTextTower(config, dtype, device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.constant_(self.logit_scale, float(np.log(1 / 0.07)))

    def encode_image(self, pixels: torch.Tensor, return_grid: bool = False) -> torch.Tensor:
        return self.visual(pixels, return_grid=return_grid)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, pixels: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(pixels), self.encode_text(tokens)


_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def preprocess_image(img: np.ndarray, resolution: int = 224) -> np.ndarray:
    """uint8 HWC image -> resized, centre-cropped, normalised float32 HWC: a bilinear resize
    of the short side to ``resolution``, then the centre crop (CLIP's transform)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    scale = resolution / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    oy, ox = (nh - resolution) // 2, (nw - resolution) // 2
    out = out[oy: oy + resolution, ox: ox + resolution]
    return (((out / 255.0) - _CLIP_MEAN) / _CLIP_STD).astype(np.float32)


class ImageCLIP:
    """The user-facing wrapper over :class:`CLIPModel`, as the JAX package's ``ImageCLIP``:
    L2-normalised image and text embeddings, the token grid, and mixed-modality batches in
    which an absent modality gives a zero embedding. ``state_dict`` is the port's (e.g. from
    :func:`import_clip_torch_state`); on the card unless ``device="cpu"``."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], clip_name: str = "ViT-L/14",
                 tokenizer=None, bpe_path: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if clip_name not in CLIP_CONFIGS:
            raise ValueError(f"unknown CLIP {clip_name!r}; known: {sorted(CLIP_CONFIGS)}")
        if tokenizer is None and bpe_path is not None:
            from ..tokenizer import SimpleTokenizer

            tokenizer = SimpleTokenizer(bpe_path)
        self.config = CLIP_CONFIGS[clip_name]
        self.clip_name = clip_name
        self.device = torch.device(device)
        self.model = CLIPModel(self.config, dtype, self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.tokenizer = tokenizer

    @property
    def feature_dim(self) -> int:
        return self.config.embed_dim

    @property
    def grid_size(self) -> int:
        return self.config.grid_size

    @property
    def grid_feature_dim(self) -> int:
        return self.config.vision_width

    def _tokenize(self, texts):
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer configured; pass token ids or a CLIP BPE "
                               "merges file (bpe_path)")
        return self.tokenizer(texts)

    def _pixels(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images, dtype=np.float32), device=self.device)

    @torch.no_grad()
    def embed_images(self, images) -> torch.Tensor:
        """Preprocessed pixels ``[N, H, W, 3]`` -> L2-normalised ``[N, embed_dim]``."""
        out = self.model.encode_image(self._pixels(images)).float()
        return out / torch.linalg.norm(out, dim=-1, keepdim=True)

    @torch.no_grad()
    def embed_text(self, prompts) -> torch.Tensor:
        """Prompts (strings) or token ids ``[N, context_length]`` -> L2-normalised
        ``[N, embed_dim]``."""
        if isinstance(prompts, (np.ndarray, torch.Tensor)):
            tokens = prompts
        else:
            tokens = self._tokenize(list(prompts))
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        out = self.model.encode_text(tokens).float()
        return out / torch.linalg.norm(out, dim=-1, keepdim=True)

    @torch.no_grad()
    def embed_images_grid(self, images) -> torch.Tensor:
        """Preprocessed pixels -> the ``[N, grid ** 2, width]`` fp32 token grid."""
        return self.model.encode_image(self._pixels(images), return_grid=True)

    def __call__(self, batch_size: int, images=None, texts=None,
                 embeddings=None) -> torch.Tensor:
        """A mixed-modality batch of embeddings: per element one of an image (uint8 HWC), a
        text or an embedding, or none (zeros)."""
        result = torch.zeros((batch_size, self.feature_dim), dtype=torch.float32,
                             device=self.device)
        image_seq = [None] * batch_size if images is None else list(images)
        text_seq = [None] * batch_size if texts is None else list(texts)
        emb_seq = [None] * batch_size if embeddings is None else list(embeddings)
        if not len(image_seq) == len(text_seq) == len(emb_seq) == batch_size:
            raise ValueError("each modality lists one entry an element")
        for i, (im, tx, em) in enumerate(zip(image_seq, text_seq, emb_seq)):
            if sum(x is not None for x in (im, tx, em)) > 1:
                raise ValueError("only one modality may be given an element")
            if em is not None:
                result[i] = torch.as_tensor(np.asarray(em), dtype=torch.float32)
        img_idx = [(i, im) for i, im in enumerate(image_seq) if im is not None]
        txt_idx = [(i, tx) for i, tx in enumerate(text_seq) if tx is not None]
        if img_idx:
            embs = self.embed_images(np.stack(
                [preprocess_image(im, self.config.image_resolution) for _, im in img_idx]))
            for (i, _), e in zip(img_idx, embs):
                result[i] = e
        if txt_idx:
            embs = self.embed_text([tx for _, tx in txt_idx])
            for (i, _), e in zip(txt_idx, embs):
                result[i] = e
        return result


# --------------------------------------------------------------------------- import

_BLOCK = re.compile(r"^(visual\.)?transformer\.resblocks\.(\d+)\.(.*)$")
_BLOCK_LEAVES = {
    "attn.in_proj_weight": "attn.in_proj.weight",
    "attn.in_proj_bias": "attn.in_proj.bias",
    "mlp.c_fc.weight": "c_fc.weight",
    "mlp.c_fc.bias": "c_fc.bias",
    "mlp.c_proj.weight": "c_proj.weight",
    "mlp.c_proj.bias": "c_proj.bias",
}
_TOP = {
    "token_embedding.weight": "text.token_embedding.weight",
    "positional_embedding": "text.positional_embedding",
    "ln_final.weight": "text.ln_final.weight",
    "ln_final.bias": "text.ln_final.bias",
    "text_projection": "text.text_projection",
    "logit_scale": "logit_scale",
}


def import_clip_torch_state(state_dict, clip_name: str = "ViT-L/14") -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP ``state_dict`` -> the port's :class:`CLIPModel` ``state_dict`` (fp32
    tensors on the CPU): the ``transformer.resblocks.{i}`` of each tower become
    ``block_{i}``, ``in_proj_weight`` becomes ``in_proj.weight``, the MLP's linears move up a
    level; the weights keep their layout. Keys of no tower of ``clip_name`` (the vocabulary's
    ``context_length``, ``input_resolution`` and ``vocab_size`` buffers) are left out."""
    cfg = CLIP_CONFIGS[clip_name]
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        m = _BLOCK.match(key)
        if m:
            visual, i, leaf = m.group(1), int(m.group(2)), m.group(3)
            if i >= (cfg.vision_layers if visual else cfg.text_layers):
                raise KeyError(f"{key}: {clip_name} has fewer layers")
            name = f"{'visual' if visual else 'text'}.block_{i}.{_BLOCK_LEAVES.get(leaf, leaf)}"
        elif key.startswith("visual."):
            name = key
        elif key in _TOP:
            name = _TOP[key]
        else:
            continue
        out[name] = _fp32(value)
    return out


def _fp32(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().cpu().float()
    return torch.as_tensor(np.asarray(value), dtype=torch.float32)
