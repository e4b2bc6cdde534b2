"""The Point-E model presets and their factory.

Counterpart of :mod:`pcdiff.models.configs`: the same named presets (the base40M family,
base300M, base1B, upsample, sdf) with the same hyperparameters, building the port's modules
of :mod:`pcdiff_torch.models.point_e` and :mod:`pcdiff_torch.models.sdf`.
"""

from __future__ import annotations

from typing import Any, Dict

from .point_e import (
    CLIPImageGridPointDiffusionTransformer,
    CLIPImageGridUpsamplePointDiffusionTransformer,
    CLIPImagePointDiffusionTransformer,
    PointDiffusionTransformer,
    UpsamplePointDiffusionTransformer,
)
from .sdf import CrossAttentionPointCloudSDFModel

__all__ = ["MODEL_CONFIGS", "model_from_config"]

_BASE40M = {
    "cond_drop_prob": 0.1,
    "heads": 8,
    "init_scale": 0.25,
    "input_channels": 6,
    "layers": 12,
    "n_ctx": 1024,
    "output_channels": 12,
    "time_token_cond": True,
    "width": 512,
}

MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    "base40M-imagevec": {
        **_BASE40M, "name": "CLIPImagePointDiffusionTransformer", "token_cond": True,
    },
    "base40M-textvec": {
        **_BASE40M, "name": "CLIPImagePointDiffusionTransformer", "token_cond": True,
    },
    "base40M-uncond": {
        k: v for k, v in {**_BASE40M, "name": "PointDiffusionTransformer"}.items()
        if k != "cond_drop_prob"
    },
    "base40M": {**_BASE40M, "name": "CLIPImageGridPointDiffusionTransformer"},
    "base300M": {
        **_BASE40M, "name": "CLIPImageGridPointDiffusionTransformer",
        "heads": 16, "layers": 24, "width": 1024,
    },
    "base1B": {
        **_BASE40M, "name": "CLIPImageGridPointDiffusionTransformer",
        "heads": 32, "layers": 24, "width": 2048,
    },
    "upsample": {
        **_BASE40M, "name": "CLIPImageGridUpsamplePointDiffusionTransformer",
        "n_ctx": 3072, "cond_ctx": 1024,
        "channel_biases": [0.0, 0.0, 0.0, -1.0, -1.0, -1.0],
        "channel_scales": [2.0, 2.0, 2.0, 0.007843137255, 0.007843137255, 0.007843137255],
    },
    "sdf": {
        "name": "CrossAttentionPointCloudSDFModel",
        "decoder_heads": 4, "decoder_layers": 4, "encoder_heads": 4,
        "encoder_layers": 8, "init_scale": 0.25, "n_ctx": 4096, "width": 256,
    },
}

_MODEL_CLASSES = {
    "PointDiffusionTransformer": PointDiffusionTransformer,
    "CLIPImagePointDiffusionTransformer": CLIPImagePointDiffusionTransformer,
    "CLIPImageGridPointDiffusionTransformer": CLIPImageGridPointDiffusionTransformer,
    "UpsamplePointDiffusionTransformer": UpsamplePointDiffusionTransformer,
    "CLIPImageGridUpsamplePointDiffusionTransformer":
        CLIPImageGridUpsamplePointDiffusionTransformer,
    "CrossAttentionPointCloudSDFModel": CrossAttentionPointCloudSDFModel,
}


def model_from_config(config: Dict[str, Any], **overrides):
    """The module named by ``config['name']``, built from the rest of ``config`` and
    ``overrides`` (``dtype``, ``device`` and any hyperparameter; on the card unless
    ``device="cpu"``)."""
    config = dict(config, **overrides)
    name = config.pop("name")
    if name not in _MODEL_CLASSES:
        raise ValueError(f"unknown model name: {name}")
    return _MODEL_CLASSES[name](**config)
