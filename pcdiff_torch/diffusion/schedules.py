"""Noise schedules and timestep respacing, in float64 numpy (counterpart of
:mod:`pcdiff.diffusion.schedules`).

The tables are computed once in float64 and gathered as float32 by the diffusion
processes.
"""

from __future__ import annotations

import math
from typing import Sequence, Set, Union

import numpy as np

__all__ = ["get_named_beta_schedule", "betas_for_alpha_bar", "space_timesteps"]


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """The beta schedule ``schedule_name`` as float64. ``linear``: the Ho et al. schedule
    rescaled so its endpoints do not depend on the step count (``[1e-4, 0.02] * 1000 / T``);
    ``cosine``: the improved-DDPM cosine alpha-bar schedule."""
    if schedule_name == "linear":
        scale = 1000.0 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """A continuous alpha-bar function as per-step betas:
    ``beta_i = 1 - alpha_bar((i + 1) / T) / alpha_bar(i / T)``, clipped at ``max_beta``."""
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    a1 = np.array([alpha_bar(ti / num_diffusion_timesteps) for ti in t])
    a2 = np.array([alpha_bar((ti + 1) / num_diffusion_timesteps) for ti in t])
    return np.minimum(1.0 - a2 / a1, max_beta)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The timesteps of a process of ``num_timesteps`` steps to keep. ``section_counts``
    is a list of per-section step counts, a comma-separated string of the same, ``"ddimN"``
    (integer striding with exactly N steps) or ``"exactA,B,..."`` (the steps themselves)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        if section_counts.startswith("exact"):
            steps = {int(x) for x in section_counts[len("exact"):].split(",")}
            for s in steps:
                if s < 0 or s >= num_timesteps:
                    raise ValueError(f"timestep out of bounds: {s}")
            return steps
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per, extra = divmod(num_timesteps, len(section_counts))
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1.0 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)
