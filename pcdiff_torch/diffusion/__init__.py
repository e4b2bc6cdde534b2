"""Diffusion processes, Karras solvers and the point-cloud sampler of the port."""

from .configs import BASE_DIFFUSION_CONFIG, DIFFUSION_CONFIGS, diffusion_from_config
from .gaussian import (
    GaussianDiffusion,
    SpacedDiffusion,
    diffusion_from_betas,
    mean_flat,
    normal_kl,
)
from .karras import (
    KarrasDenoiser,
    get_sigmas_karras,
    karras_sample,
    sample_dpm,
    sample_euler_ancestral,
    sample_guided_interval,
    sample_heun,
    sample_heun_reuse,
    sigma_to_t,
)
from .parallel import sample_heun_parallel
from .sampler import PointCloudSampler
from .schedules import betas_for_alpha_bar, get_named_beta_schedule, space_timesteps

__all__ = [
    "BASE_DIFFUSION_CONFIG",
    "DIFFUSION_CONFIGS",
    "diffusion_from_config",
    "GaussianDiffusion",
    "SpacedDiffusion",
    "diffusion_from_betas",
    "mean_flat",
    "normal_kl",
    "KarrasDenoiser",
    "get_sigmas_karras",
    "karras_sample",
    "sample_dpm",
    "sample_euler_ancestral",
    "sample_guided_interval",
    "sample_heun",
    "sample_heun_parallel",
    "sample_heun_reuse",
    "sigma_to_t",
    "PointCloudSampler",
    "betas_for_alpha_bar",
    "get_named_beta_schedule",
    "space_timesteps",
]
