"""Multi-stage point-cloud sampling orchestration.

Counterpart of :class:`pcdiff.diffusion.sampler.PointCloudSampler`: a stack of (model,
diffusion) stages (base, then upsamplers conditioned on the previous output through
``low_res``), per-stage arguments broadcast from scalars or lists, CFG as one 2B-row call
with the kwargs doubled by zeros (``prev_latent`` excluded), each stage solved on a Karras
grid (``heun``, ``heun_reuse``, ``dpm``, ``ancestral`` or ``heun_parallel``, optionally
with CFG restricted to a guidance interval) or by the DDPM ancestral chain
(``use_karras`` false), and the outputs concatenated along the point axis.

Models are duck-typed callables ``model(x, t, **kwargs) -> out | (out, latent)`` with
optional hooks: ``cached_model_kwargs(batch_size, model_kwargs)`` (encode the
conditioning once a stage), ``cfg_model_kwargs(batch_size, model_kwargs)`` (the 2B-row
CFG kwargs) and ``init_latent(batch_size)`` (the self-conditioning carry);
:class:`pcdiff_torch.models.BoundTwoStream` has all three. Every normal comes from the
caller's ``torch.Generator``, on its device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from ..geometry.point_cloud import PointCloud
from . import _noise
from .gaussian import GaussianDiffusion, SpacedDiffusion, _split_model_output
from .karras import SOLVERS, karras_sample

__all__ = ["PointCloudSampler"]


def _broadcast(value, n: int, name: str) -> list:
    """A per-stage argument as a list of ``n``: one value is repeated, except that a
    single guidance scale guides the first stage only (the upsamplers get 1.0)."""
    seq = list(value) if isinstance(value, (list, tuple)) else [value]
    if len(seq) == 1 and n > 1:
        seq = seq + [1.0] * (n - 1) if name == "guidance_scale" else seq * n
    if len(seq) != n:
        raise ValueError(f"{name}: expected {n} entries, got {len(seq)}")
    return seq


def _default_cfg_kwargs(model_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """CFG kwargs for a model without the hook: every kwarg doubled with zeros."""
    return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in model_kwargs.items()
            if k != "prev_latent"}


class PointCloudSampler:
    """A stack of (model, diffusion) stages sampled one after the other."""

    def __init__(
        self,
        models: Sequence[Callable],
        diffusions: Sequence[GaussianDiffusion],
        num_points: Sequence[int],
        aux_channels: Sequence[str] = (),
        model_kwargs_key_filter: Sequence[str] = ("*",),
        guidance_scale: Union[float, Sequence[float]] = (3.0, 3.0),
        clip_denoised: bool = True,
        use_karras: Union[bool, Sequence[bool]] = (True, True),
        karras_steps: Union[int, Sequence[int]] = (64, 64),
        sigma_min: Union[float, Sequence[float]] = (1e-3, 1e-3),
        sigma_max: Union[float, Sequence[float]] = (120, 160),
        s_churn: Union[float, Sequence[float]] = (3, 0),
        sampler: str = "heun",
        parallel_options: Optional[Dict[str, Any]] = None,
        guidance_interval: Optional[Tuple[float, float]] = None,
    ):
        n = len(models)
        if n == 0 or len(diffusions) != n:
            raise ValueError(f"{n} models and {len(diffusions)} diffusions: one each a stage")
        if sampler not in SOLVERS:
            raise ValueError(f"sampler must be one of {SOLVERS}, not {sampler!r}")
        self.models = list(models)
        self.diffusions = list(diffusions)
        self.num_points = _broadcast(num_points, n, "num_points")
        self.aux_channels = list(aux_channels)
        self.guidance_scale = _broadcast(guidance_scale, n, "guidance_scale")
        self.clip_denoised = clip_denoised
        self.use_karras = _broadcast(use_karras, n, "use_karras")
        self.karras_steps = _broadcast(karras_steps, n, "karras_steps")
        self.sigma_min = _broadcast(sigma_min, n, "sigma_min")
        self.sigma_max = _broadcast(sigma_max, n, "sigma_max")
        self.s_churn = _broadcast(s_churn, n, "s_churn")
        kf = list(model_kwargs_key_filter) or ["*"] * n
        self.model_kwargs_key_filter = _broadcast(kf, n, "model_kwargs_key_filter")
        self.sampler = sampler
        self.parallel_options = dict(parallel_options or {})
        self.guidance_interval = tuple(guidance_interval) if guidance_interval else None
        self.parallel_iters: List[int] = []  # heun_parallel's rounds, a stage each

    @property
    def num_stages(self) -> int:
        return len(self.models)

    # ------------------------------------------------------------ stage loop

    def _stage_sample(self, stage: int, batch_size: int, model_kwargs: Dict[str, Any],
                      generator: torch.Generator,
                      low_res: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run one stage end to end; returns its final pred_xstart [B, N, C]."""
        model = self.models[stage]
        guidance = self.guidance_scale[stage]
        shape = (batch_size, self.num_points[stage], 3 + len(self.aux_channels))

        kwargs = dict(model_kwargs)
        if self.model_kwargs_key_filter[stage] != "*":
            use = set(self.model_kwargs_key_filter[stage].split(","))
            kwargs = {k: v for k, v in kwargs.items() if k in use}
        if low_res is not None:
            kwargs["low_res"] = low_res
        if hasattr(model, "cached_model_kwargs"):
            kwargs = model.cached_model_kwargs(batch_size, kwargs)
        guided = guidance not in (0.0, 1.0)
        if guided:
            kwargs = (model.cfg_model_kwargs(batch_size, kwargs)
                      if hasattr(model, "cfg_model_kwargs") else _default_cfg_kwargs(kwargs))
        init_state = (model.init_latent(batch_size * (2 if guided else 1))
                      if hasattr(model, "init_latent") else None)
        if self.use_karras[stage]:
            return self._karras_stage(stage, shape, kwargs, generator, init_state)
        return self._ancestral_stage(stage, shape, kwargs, generator, init_state)

    def _karras_stage(self, stage: int, shape, kwargs: Dict[str, Any],
                      generator: torch.Generator, init_state) -> torch.Tensor:
        out = karras_sample(
            self.diffusions[stage], self.models[stage], shape, self.karras_steps[stage],
            generator, clip_denoised=self.clip_denoised, model_kwargs=kwargs,
            sigma_min=self.sigma_min[stage], sigma_max=self.sigma_max[stage],
            sampler=self.sampler, s_churn=self.s_churn[stage],
            guidance_scale=self.guidance_scale[stage],
            guidance_interval=self.guidance_interval, init_state=init_state,
            parallel_options=self.parallel_options, device=generator.device)
        if "parallel_iters" in out:
            self.parallel_iters.append(out["parallel_iters"])
        return out["pred_xstart"]

    def _ancestral_stage(self, stage: int, shape, kwargs: Dict[str, Any],
                         generator: torch.Generator, init_state) -> torch.Tensor:
        """The DDPM ancestral chain, T-1 down to 0, with fused-CFG outputs and the latent
        carry. A respaced process's model sees the base process's timesteps. This differs
        on purpose from ``pcdiff.diffusion.sampler._ancestral_stage``, whose model sees the
        spaced indices: that stage calls the model itself, outside the timestep map that
        ``SpacedDiffusion`` applies to the models it is given."""
        model, diffusion = self.models[stage], self.diffusions[stage]
        guidance = self.guidance_scale[stage]
        guided = guidance not in (0.0, 1.0)
        b = shape[0]

        def model_t(t_batch):
            if isinstance(diffusion, SpacedDiffusion):
                return diffusion.map_timesteps(t_batch)
            return t_batch

        def eps_fn(x, t_batch, state):
            t = model_t(t_batch)
            if guided:
                out, new_state = _split_model_output(
                    model(torch.cat([x, x]), torch.cat([t, t]), prev_latent=state, **kwargs))
                cond_eps, uncond_eps = torch.chunk(out, 2, dim=0)
                eps = uncond_eps + guidance * (cond_eps - uncond_eps)
            else:
                eps, new_state = _split_model_output(
                    model(x, t, prev_latent=state, **kwargs))
            return eps, (state if new_state is None else new_state)

        x = _noise.normal(shape, generator, generator.device)
        state, pred = init_state, None
        for t_scalar in range(diffusion.num_timesteps - 1, -1, -1):
            t_batch = torch.full((b,), t_scalar, dtype=torch.long, device=x.device)
            eps, state = eps_fn(x, t_batch, state)
            out = diffusion.p_sample(lambda *_a, **_k: eps, x, t_batch, generator,
                                     clip_denoised=self.clip_denoised)
            x, pred = out["sample"], out["pred_xstart"]
        return diffusion.unscale_channels(pred)

    # ------------------------------------------------------------ public API

    def sample_batch_progressive(self, batch_size: int, model_kwargs: Dict[str, Any],
                                 generator: torch.Generator) -> Iterator[torch.Tensor]:
        """Yield the samples after each stage, [B, points so far, 3 + aux]: each stage's
        output feeds the next through ``low_res`` and is appended along the point axis."""
        samples = None
        self.parallel_iters = []
        for stage in range(self.num_stages):
            with torch.no_grad():
                out = self._stage_sample(stage, batch_size, model_kwargs, generator,
                                         low_res=samples)
            samples = out if samples is None else torch.cat([samples, out], dim=1)
            yield samples

    def sample_batch(self, batch_size: int, model_kwargs: Dict[str, Any],
                     generator: torch.Generator) -> torch.Tensor:
        """Final samples [B, total points, 3 + aux] across all stages."""
        samples = None
        for samples in self.sample_batch_progressive(batch_size, model_kwargs, generator):
            pass
        return samples

    # ---------------------------------------------------------- conversions

    def split_model_output(self, output: torch.Tensor, rescale_colors: bool = False
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """[B, N, 3 + aux] as positions and the named aux channels (colours rounded and
        clipped to [0, 255], or [0, 1] with ``rescale_colors``)."""
        if 3 + len(self.aux_channels) != output.shape[-1]:
            raise ValueError(f"{output.shape[-1]} channels, expected "
                             f"{3 + len(self.aux_channels)}")
        pos, joined_aux = output[..., :3], output[..., 3:]
        aux = {}
        for i, name in enumerate(self.aux_channels):
            v = joined_aux[..., i]
            if name in {"R", "G", "B", "A"}:
                v = torch.round(torch.clamp(v, 0, 255))
                if rescale_colors:
                    v = v / 255.0
            aux[name] = v
        return pos, aux

    def output_to_point_clouds(self, output: torch.Tensor) -> List[PointCloud]:
        pos, aux = self.split_model_output(output, rescale_colors=True)
        pos_np = pos.detach().float().cpu().numpy()
        aux_np = {k: v.detach().float().cpu().numpy() for k, v in aux.items()}
        return [PointCloud(coords=pos_np[i], channels={k: v[i] for k, v in aux_np.items()})
                for i in range(pos_np.shape[0])]

    @classmethod
    def combine(cls, *samplers: "PointCloudSampler") -> "PointCloudSampler":
        """One sampler of all the given samplers' stages, in order."""
        first = samplers[0]
        if any(s.aux_channels != first.aux_channels or s.clip_denoised != first.clip_denoised
               for s in samplers[1:]):
            raise ValueError("samplers to combine must share aux_channels and clip_denoised")

        def cat(attr):
            return [x for s in samplers for x in getattr(s, attr)]

        return cls(models=cat("models"), diffusions=cat("diffusions"),
                   num_points=cat("num_points"), aux_channels=first.aux_channels,
                   model_kwargs_key_filter=cat("model_kwargs_key_filter"),
                   guidance_scale=cat("guidance_scale"), clip_denoised=first.clip_denoised,
                   use_karras=cat("use_karras"), karras_steps=cat("karras_steps"),
                   sigma_min=cat("sigma_min"), sigma_max=cat("sigma_max"),
                   s_churn=cat("s_churn"))

    def with_options(self, guidance_scale, clip_denoised: bool, use_karras=(True, True),
                     karras_steps=(64, 64), sigma_min=(1e-3, 1e-3), sigma_max=(120, 160),
                     s_churn=(3, 0)) -> "PointCloudSampler":
        """The same stages under other solver options."""
        return PointCloudSampler(
            models=self.models, diffusions=self.diffusions, num_points=self.num_points,
            aux_channels=self.aux_channels,
            model_kwargs_key_filter=self.model_kwargs_key_filter,
            guidance_scale=guidance_scale, clip_denoised=clip_denoised,
            use_karras=use_karras, karras_steps=karras_steps, sigma_min=sigma_min,
            sigma_max=sigma_max, s_churn=s_churn)
