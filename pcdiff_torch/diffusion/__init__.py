"""Diffusion processes, Karras solvers and the point-cloud sampler of the port."""

from .gaussian import GaussianDiffusion, diffusion_from_betas
from .karras import (
    get_sigmas_karras,
    sample_guided_interval,
    sample_heun,
    sample_heun_reuse,
    sigma_to_t,
)
from .sampler import PointCloudSampler
from .schedules import get_named_beta_schedule

__all__ = [
    "GaussianDiffusion",
    "diffusion_from_betas",
    "get_sigmas_karras",
    "sample_guided_interval",
    "sample_heun",
    "sample_heun_reuse",
    "sigma_to_t",
    "PointCloudSampler",
    "get_named_beta_schedule",
]
