"""Named checkpoints and where they are looked for on disk.

Counterpart of the cache-path logic of :mod:`pcdiff.models.download`, with the same names
(the Point-E family and the P-FID PointNet++ classifier) and file names. The port fetches
nothing: :func:`checkpoint_path` resolves a name to its file in the cache directory and
raises, naming the file, where it is absent; place the published file there (or pass a path
to the entry points).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["MODEL_FILES", "default_cache_dir", "checkpoint_path", "load_checkpoint"]

MODEL_FILES = {
    "base40M-imagevec": "base_40m_imagevec.pt",
    "base40M-textvec": "base_40m_textvec.pt",
    "base40M-uncond": "base_40m_uncond.pt",
    "base40M": "base_40m.pt",
    "base300M": "base_300m.pt",
    "base1B": "base_1b.pt",
    "upsample": "upsample_40m.pt",
    "sdf": "sdf.pt",
    "pointnet": "pointnet.pt",
}


def default_cache_dir() -> str:
    """``~/.cache/pcdiff``, as the JAX package's cache."""
    return os.path.join(os.path.expanduser("~"), ".cache", "pcdiff")


def checkpoint_path(checkpoint_name: str, cache_dir: Optional[str] = None) -> str:
    """The local file of a named checkpoint. Raises ValueError for an unknown name and
    FileNotFoundError, naming the file, where it is not in ``cache_dir``."""
    if checkpoint_name not in MODEL_FILES:
        raise ValueError(f"unknown checkpoint name {checkpoint_name!r}; "
                         f"known: {sorted(MODEL_FILES)}")
    path = os.path.join(cache_dir or default_cache_dir(), MODEL_FILES[checkpoint_name])
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {checkpoint_name!r} is not on disk: place "
                                f"{MODEL_FILES[checkpoint_name]} at {path}")
    return path


def load_checkpoint(checkpoint_name: str, cache_dir: Optional[str] = None):
    """The raw torch ``state_dict`` of a named checkpoint (on the CPU); the importers of
    :mod:`pcdiff_torch.core.point_e_import` and :mod:`pcdiff_torch.models.clip` convert it."""
    import torch

    sd = torch.load(checkpoint_path(checkpoint_name, cache_dir), map_location="cpu",
                    weights_only=True)
    if checkpoint_name == "pointnet" and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return sd
