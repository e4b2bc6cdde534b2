"""Point-E diffusion presets and their factory (counterpart of
:mod:`pcdiff.diffusion.configs`): cosine 1024-step base models, a linear upsampler, the
XYZ + RGB channel scales and biases, and optional respacing."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .gaussian import GaussianDiffusion, SpacedDiffusion
from .schedules import get_named_beta_schedule, space_timesteps

__all__ = ["BASE_DIFFUSION_CONFIG", "DIFFUSION_CONFIGS", "diffusion_from_config"]

BASE_DIFFUSION_CONFIG: Dict[str, Any] = {
    "channel_biases": [0.0, 0.0, 0.0, -1.0, -1.0, -1.0],
    "channel_scales": [2.0, 2.0, 2.0, 0.007843137255, 0.007843137255, 0.007843137255],
    "mean_type": "epsilon",
    "schedule": "cosine",
    "timesteps": 1024,
}

DIFFUSION_CONFIGS: Dict[str, Dict[str, Any]] = {
    "base40M-imagevec": BASE_DIFFUSION_CONFIG,
    "base40M-textvec": BASE_DIFFUSION_CONFIG,
    "base40M-uncond": BASE_DIFFUSION_CONFIG,
    "base40M": BASE_DIFFUSION_CONFIG,
    "base300M": BASE_DIFFUSION_CONFIG,
    "base1B": BASE_DIFFUSION_CONFIG,
    "upsample": {**BASE_DIFFUSION_CONFIG, "schedule": "linear"},
}


def diffusion_from_config(config: Dict[str, Any]) -> GaussianDiffusion:
    """The process a preset describes: its schedule and step count, the ``learned_range``
    variance with the ``mse`` loss, its channel scales and biases, and ``respacing`` when
    the preset has one."""
    steps = config["timesteps"]
    respace = config.get("respacing", None)
    channel_scales = config.get("channel_scales")
    channel_biases = config.get("channel_biases")
    kwargs = dict(
        betas=get_named_beta_schedule(config["schedule"], steps),
        model_mean_type=config.get("mean_type", "epsilon"),
        model_var_type="learned_range",
        loss_type="mse",
        channel_scales=None if channel_scales is None else np.array(channel_scales),
        channel_biases=None if channel_biases is None else np.array(channel_biases),
    )
    if respace is None:
        return GaussianDiffusion(**kwargs)
    return SpacedDiffusion(use_timesteps=space_timesteps(steps, respace), **kwargs)
