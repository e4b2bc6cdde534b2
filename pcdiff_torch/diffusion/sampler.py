"""Point-cloud sampling orchestration.

Counterpart of :class:`pcdiff.diffusion.sampler.PointCloudSampler` for one Karras stage,
the flagship's. The constructor takes the JAX package's per-stage arguments, as lists of
one entry or as scalars. The model's hooks encode the conditioning once
(``cached_model_kwargs``), build the 2B-row CFG kwargs (``cfg_model_kwargs``) and give
the RIN latent carry (``init_latent``); CFG may be restricted to a guidance interval.
``x_T`` comes from a ``torch.Generator`` on the model's device. Upsampler stages, the
ancestral stage and ``heun_parallel`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .gaussian import GaussianDiffusion
from .karras import (
    _SAMPLERS,
    gaussian_denoise_fn,
    get_sigmas_karras,
    guided_denoise_fn,
    half_model_kwargs,
    sample_guided_interval,
)

__all__ = ["PointCloudSampler"]


def _one(value, name: str):
    """The single stage's value of a per-stage argument (a scalar or a list of one)."""
    seq = list(value) if isinstance(value, (list, tuple)) else [value]
    if len(seq) != 1:
        raise NotImplementedError(
            f"{name}: {len(seq)} stages given; only one stage is ported (no upsampler)")
    return seq[0]


class PointCloudSampler:
    """One (model, diffusion) stage sampled on a Karras sigma grid. ``model`` is a
    callable ``model(x, t, **kwargs) -> (eps, latent)`` with the sampling hooks of
    :class:`pcdiff_torch.models.BoundTwoStream`."""

    def __init__(
        self,
        models: Sequence[Any],
        diffusions: Sequence[GaussianDiffusion],
        num_points: Sequence[int],
        aux_channels: Sequence[str] = (),
        guidance_scale: float = 3.0,
        clip_denoised: bool = True,
        use_karras: bool = True,
        karras_steps: int = 64,
        sigma_min: float = 1e-3,
        sigma_max: float = 120.0,
        s_churn: float = 0.0,
        sampler: str = "heun",
        guidance_interval: Optional[Tuple[float, float]] = None,
    ):
        if sampler not in _SAMPLERS:
            raise NotImplementedError(f"sampler {sampler!r} is not ported")
        if not _one(use_karras, "use_karras"):
            raise NotImplementedError("the ancestral stage is not ported yet")
        self.model = _one(models, "models")
        self.diffusion = _one(diffusions, "diffusions")
        self.num_points = _one(num_points, "num_points")
        self.channels = 3 + len(aux_channels)
        self.guidance_scale = _one(guidance_scale, "guidance_scale")
        self.clip_denoised = clip_denoised
        self.karras_steps = _one(karras_steps, "karras_steps")
        self.sigma_min = _one(sigma_min, "sigma_min")
        self.sigma_max = _one(sigma_max, "sigma_max")
        self.s_churn = _one(s_churn, "s_churn")
        self.sampler = sampler
        self.guidance_interval = tuple(guidance_interval) if guidance_interval else None
        if self.guidance_interval is not None and self.s_churn != 0.0:
            raise NotImplementedError("guidance_interval requires s_churn == 0")

    @property
    def guided(self) -> bool:
        return self.guidance_scale not in (0.0, 1.0)

    def _karras_stage(self, shape, kwargs: Dict[str, Any], generator: torch.Generator,
                      init_state) -> torch.Tensor:
        """Solve the stage from fresh noise; returns the final pred_xstart [B, N, C]."""
        model, diffusion = self.model, self.diffusion
        base = gaussian_denoise_fn(model, diffusion, clip_denoised=self.clip_denoised,
                                   model_kwargs=kwargs)
        denoise = guided_denoise_fn(base, self.guidance_scale) if self.guided else base
        sigmas = get_sigmas_karras(self.karras_steps, self.sigma_min, self.sigma_max)
        x_T = torch.randn(shape, generator=generator, device=generator.device) \
            * self.sigma_max
        if self.guidance_interval is not None and self.guided:
            denoise_cond = gaussian_denoise_fn(
                model, diffusion, clip_denoised=self.clip_denoised,
                model_kwargs=half_model_kwargs(kwargs, shape[0]))
            out = sample_guided_interval(
                denoise_cond, denoise, x_T, sigmas, state=init_state,
                guidance_interval=self.guidance_interval, sampler=self.sampler,
                cond_batch=shape[0])
        else:
            out = _SAMPLERS[self.sampler](denoise, x_T, sigmas, state=init_state,
                                          s_churn=self.s_churn)
        return diffusion.unscale_channels(out["pred_xstart"])

    @torch.no_grad()
    def sample_batch(self, batch_size: int, model_kwargs: Dict[str, Any],
                     generator: torch.Generator) -> torch.Tensor:
        """Final samples [B, num_points, 3 + aux]."""
        kwargs = self.model.cached_model_kwargs(batch_size, dict(model_kwargs))
        if self.guided:
            kwargs = self.model.cfg_model_kwargs(batch_size, kwargs)
        init_state = self.model.init_latent(batch_size * (2 if self.guided else 1))
        shape = (batch_size, self.num_points, self.channels)
        return self._karras_stage(shape, kwargs, generator, init_state)
