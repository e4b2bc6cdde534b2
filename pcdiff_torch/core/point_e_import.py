"""The reference's Point-E checkpoints in the port's modules.

Counterpart of :mod:`pcdiff.core.point_e_import`: a published Point-E ``state_dict`` (of
the reference's ``transformer.py`` / ``sdf.py`` modules: base40M, base300M, base1B,
upsample, sdf) -> the ``state_dict`` of the matching module of
:mod:`pcdiff_torch.models.point_e` / :mod:`pcdiff_torch.models.sdf`. Both are torch
layouts, so only names change: ``resblocks.{i}`` -> ``resblock_{i}``, and the grid
variants' ``clip_embed`` ``Sequential(LayerNorm, Linear)`` -> ``clip_embed_ln`` and
``clip_embed``. Values become fp32 tensors on the CPU.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["import_point_e_torch_state", "import_sdf_torch_state"]

_RENAMES = (
    (re.compile(r"^(backbone|encoder|decoder)\.resblocks\.(\d+)\."), r"\1.resblock_\2."),
    (re.compile(r"^clip_embed\.0\."), "clip_embed_ln."),
    (re.compile(r"^clip_embed\.1\."), "clip_embed."),
)


def _fp32(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().cpu().float()
    return torch.as_tensor(np.asarray(value), dtype=torch.float32)


def _rename(state_dict) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in state_dict.items():
        for rx, sub in _RENAMES:
            key = rx.sub(sub, key)
        out[key] = _fp32(value)
    return out


def import_point_e_torch_state(state_dict) -> Dict[str, torch.Tensor]:
    """A Point-E denoiser ``state_dict`` -> the port's, for the matching class of
    :mod:`pcdiff_torch.models.point_e`."""
    return _rename(state_dict)


def import_sdf_torch_state(state_dict) -> Dict[str, torch.Tensor]:
    """An SDF model ``state_dict`` -> the port's, for
    :class:`pcdiff_torch.models.sdf.CrossAttentionPointCloudSDFModel`."""
    return _rename(state_dict)
