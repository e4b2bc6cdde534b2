"""Noise schedules, in float64 numpy (counterpart of :mod:`pcdiff.diffusion.schedules`).

Only the linear schedule, the one the flagship sampler uses, is ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_named_beta_schedule"]


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """The beta schedule ``schedule_name`` as float64. ``linear``: the Ho et al. schedule
    rescaled so its endpoints do not depend on the step count (``[1e-4, 0.02] * 1000 / T``)."""
    if schedule_name == "linear":
        scale = 1000.0 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    raise NotImplementedError(f"beta schedule {schedule_name!r} is not ported")
