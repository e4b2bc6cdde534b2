"""TwoStreamDenoiser: the flagship multimodal completion denoiser.

Counterpart of :mod:`pcdiff.models.two_stream`. Modality presence is a [B] mask per
modality: explicit through ``presence`` (the CFG sampler marks the zeroed rows), or by
default the reference's batch-level any-nonzero check. ``encode_modalities`` runs the
encoders once and ``assemble_conditioning`` applies the cheap per-forward parts (type
embeddings, CFG dropout), so that the train step shares one encoding between the
self-conditioning bootstrap and the main forward; ``encode_conditioning`` is the two in
one, and ``forward`` takes its result back as ``cond_tokens`` and skips the encoders.
Token-type ids are fixed per modality (class=0, view=1, partial_pcd=2, depth=3). In eval
mode the type embeddings are presence-masked; in train mode (``model.train()``) they are
added unmasked and CFG dropout combines a full-batch drop mask with per-modality keep
masks, drawn from the generator of
:func:`pcdiff_torch.models.attention.dropout_generator`. Submodules carry the names of
the flax parameter tree (``backbone``, ``encoders_<modality>``,
``token_type_embeddings``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from .attention import draw_uniform
from .encoders import (
    ClassEmbedding,
    DepthMapEncoder,
    Embed,
    PartialPointCloudEncoder,
    ViewAngleEmbedding,
)
from .rin import DenoiserBackbone

__all__ = ["TwoStreamDenoiser", "MODALITY_TOKEN_IDS"]

MODALITY_TOKEN_IDS = {"class": 0, "view": 1, "partial_pcd": 2, "depth": 3}
_INPUT_OF = {"class": "class_labels", "view": "viewpoints", "partial_pcd": "partial_pcd",
             "depth": "depth_maps"}


class TwoStreamDenoiser(nn.Module):
    """RIN backbone + multimodal conditioning encoders. Points are channels-last
    ([B, N, C]); depth maps are NHWC. Built on ``device``, the card unless the caller
    asks for the CPU (``device="cpu"``). It starts in eval mode, as the JAX package's
    ``train=False`` default; ``model.train()`` turns on dropout and CFG dropout."""

    def __init__(self, num_points: int = 1024, num_latents: int = 256,
                 cond_drop_prob: float = 0.1, input_channels: int = 3,
                 output_channels: int = 3, latent_dim: int = 768, x_dim: int = 512,
                 num_blocks: int = 6, num_compute_layers: int = 4, num_classes: int = 16,
                 num_heads: int = 8, num_tokens_ppcd: int = 64, num_tokens_depth: int = 32,
                 depth_image_size: int = 512, depth_patch: int = 32,
                 active_modalities: Sequence[str] = ("class", "view", "partial_pcd", "depth"),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_points = num_points
        self.num_latents = num_latents
        self.cond_drop_prob = cond_drop_prob
        self.latent_dim = latent_dim
        self.num_tokens_ppcd = num_tokens_ppcd
        self.num_tokens_depth = num_tokens_depth
        self.active_modalities = tuple(active_modalities)
        self.dtype = dtype
        self.backbone = DenoiserBackbone(
            input_channels=input_channels, output_channels=output_channels,
            num_x=num_points, num_z=num_latents, z_dim=latent_dim, x_dim=x_dim,
            num_blocks=num_blocks, num_compute_layers=num_compute_layers,
            num_heads=num_heads, dtype=dtype, device=device)
        for m in self.active_modalities:
            if m == "class":
                enc = ClassEmbedding(num_classes, latent_dim, dtype, device)
            elif m == "view":
                enc = ViewAngleEmbedding(3, latent_dim, dtype, device)
            elif m == "partial_pcd":
                enc = PartialPointCloudEncoder(embed_dim=latent_dim, num_tokens=num_tokens_ppcd,
                                               dtype=dtype, device=device)
            elif m == "depth":
                enc = DepthMapEncoder(in_channels=1, embed_dim=latent_dim,
                                      num_tokens=num_tokens_depth, patch=depth_patch,
                                      image_size=depth_image_size, dtype=dtype, device=device)
            else:
                raise ValueError(f"unknown modality: {m}")
            setattr(self, f"encoders_{m}", enc)
        self.token_type_embeddings = Embed(4, latent_dim, 0.005, dtype, device)
        self.eval()

    def modality_token_counts(self) -> Dict[str, int]:
        counts = {"class": 1, "view": 1, "partial_pcd": self.num_tokens_ppcd,
                  "depth": self.num_tokens_depth}
        return {m: counts[m] for m in self.active_modalities}

    @property
    def num_cond_tokens(self) -> int:
        return sum(self.modality_token_counts().values())

    @property
    def latent_tokens(self) -> int:
        """Length of the self-conditioning latent: z_init + cond + time."""
        return self.num_latents + self.num_cond_tokens + 1

    def _presence(self, value: torch.Tensor, override: Optional[torch.Tensor]) -> torch.Tensor:
        """Explicit override, else the reference's batch-level any-nonzero check."""
        if override is not None:
            return override.to(self.dtype)
        return (value != 0).any().to(self.dtype)

    def encode_modalities(self, batch_size: int, class_labels=None, viewpoints=None,
                          partial_pcd=None, depth_maps=None,
                          presence: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Run the modality encoders once: ``{modality: (tokens * presence [B, count, D],
        presence [B, 1, 1])}``, ``None`` for an absent input."""
        presence = presence or {}
        inputs = {"class_labels": class_labels, "viewpoints": viewpoints,
                  "partial_pcd": partial_pcd, "depth_maps": depth_maps}
        raw: Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]] = {}
        for m in self.active_modalities:
            value = inputs[_INPUT_OF[m]]
            if value is None:
                raw[m] = None
                continue
            p = self._presence(value, presence.get(m))
            p = torch.broadcast_to(p, (batch_size,))[:, None, None]
            raw[m] = (getattr(self, f"encoders_{m}")(value) * p, p)
        return raw

    def assemble_conditioning(self, raw: Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]],
                              batch_size: int) -> torch.Tensor:
        """Type embeddings (+ CFG dropout in train mode) over the encoded modalities ->
        [B, num_cond, D]. Each call in train mode draws fresh masks."""
        device = self.token_type_embeddings.weight.device
        keep = None
        if self.training and self.cond_drop_prob > 0.0:
            full_drop = draw_uniform((batch_size,), device) < self.cond_drop_prob
            keep = draw_uniform((batch_size, len(self.active_modalities)),
                                device) >= self.cond_drop_prob
            keep = (keep & ~full_drop[:, None]).to(self.dtype)
        chunks = []
        for i, (m, count) in enumerate(self.modality_token_counts().items()):
            if raw.get(m) is None:
                tokens = torch.zeros(batch_size, count, self.latent_dim, dtype=self.dtype,
                                     device=device)
                p = torch.zeros(batch_size, 1, 1, dtype=self.dtype, device=device)
            else:
                tokens, p = raw[m]
            ids = torch.full((count,), MODALITY_TOKEN_IDS[m], dtype=torch.long, device=device)
            type_emb = self.token_type_embeddings(ids)[None]
            if self.training:
                chunk = tokens + type_emb
                if keep is not None:
                    chunk = chunk * keep[:, i][:, None, None]
            else:
                chunk = tokens + type_emb * p
            chunks.append(chunk)
        return torch.cat(chunks, dim=1)

    def encode_conditioning(self, batch_size: int, class_labels=None, viewpoints=None,
                            partial_pcd=None, depth_maps=None,
                            presence: Optional[Dict[str, torch.Tensor]] = None
                            ) -> torch.Tensor:
        """All conditioning tokens, type embeddings applied -> [B, num_cond, D]. Absent
        inputs give zero tokens and zero presence."""
        raw = self.encode_modalities(batch_size, class_labels=class_labels,
                                     viewpoints=viewpoints, partial_pcd=partial_pcd,
                                     depth_maps=depth_maps, presence=presence)
        return self.assemble_conditioning(raw, batch_size)

    def forward(self, x: torch.Tensor, t: torch.Tensor, class_labels=None, viewpoints=None,
                partial_pcd=None, depth_maps=None, prev_latent: Optional[torch.Tensor] = None,
                cond_tokens: Optional[torch.Tensor] = None,
                presence: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, num_points, C] channels-last. Returns (eps_hat, latent)."""
        if x.shape[1] != self.num_points:
            raise ValueError(f"input point cloud must have {self.num_points} points, "
                             f"got {x.shape[1]}")
        if cond_tokens is None:
            cond_tokens = self.encode_conditioning(
                x.shape[0], class_labels=class_labels, viewpoints=viewpoints,
                partial_pcd=partial_pcd, depth_maps=depth_maps, presence=presence)
        return self.backbone(x, t, cond=cond_tokens, prev_latent=prev_latent)
