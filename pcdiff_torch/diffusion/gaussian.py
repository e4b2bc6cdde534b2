"""Gaussian (DDPM) diffusion over precomputed tables.

Counterpart of :mod:`pcdiff.diffusion.gaussian`, for what the Karras sampler and the
train step need: the coefficient tables are computed once in float64 numpy and gathered
as float32; ``p_mean_variance`` and ``training_losses`` cover epsilon prediction with the
``fixed_small`` variance and the ``mse`` loss, plus the chamfer-XYZ term. Layout is
channels-last ([B, N, C]). The ancestral/DDIM loops and the kl and learned-variance
losses are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..geometry.ops import chamfer_distance_xyz
from .schedules import get_named_beta_schedule

__all__ = ["GaussianDiffusion", "diffusion_from_betas", "mean_flat"]


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes -> [B]."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _split_model_output(out: Any) -> Tuple[torch.Tensor, Any]:
    """Normalise a model output to (array, extra)."""
    if isinstance(out, tuple):
        return out[0], (out[1] if len(out) == 2 else out[1:])
    return out, None


class GaussianDiffusion:
    """Diffusion-process coefficient tables plus the functions the sampler calls, for an
    epsilon-predicting model with the ``fixed_small`` variance (the JAX package's
    defaults; its other mean and variance types are not ported)."""

    def __init__(self, *, betas: Sequence[float],
                 channel_scales: Optional[np.ndarray] = None,
                 channel_biases: Optional[np.ndarray] = None):
        self.channel_scales = (
            None if channel_scales is None else np.asarray(channel_scales, dtype=np.float64))
        self.channel_biases = (
            None if channel_biases is None else np.asarray(channel_biases, dtype=np.float64))

        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        self.betas = betas
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas, axis=0)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        # log is clipped: the posterior variance is 0 at the chain's start
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod))
        self._device_tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def table(self, name: str, device) -> torch.Tensor:
        """The float64 table ``name`` as a float32 tensor on ``device`` (cached)."""
        key = (name, torch.device(device))
        t = self._device_tables.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name)), dtype=torch.float32,
                                device=device)
            self._device_tables[key] = t
        return t

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Gather float32 table values at t and broadcast to ndim dims."""
        vals = self.table(name, t.device)[t]
        return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t ~ q(x_t | x_0) with the given standard-normal noise."""
        nd = x_start.ndim
        return (self._extract("sqrt_alphas_cumprod", t, nd) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """Moments of the diffusion posterior q(x_{t-1} | x_t, x_0)."""
        nd = x_t.ndim
        mean = (self._extract("posterior_mean_coef1", t, nd) * x_start
                + self._extract("posterior_mean_coef2", t, nd) * x_t)
        return (mean, self._extract("posterior_variance", t, nd),
                self._extract("posterior_log_variance_clipped", t, nd))

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, nd) * eps)

    def p_mean_variance(self, model: Callable, x: torch.Tensor, t: torch.Tensor,
                        clip_denoised: bool = False,
                        model_kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Moments of p(x_{t-1} | x_t) plus the model's x_0 prediction: a dict with mean /
        variance / log_variance / pred_xstart / extra (the model's tuple extra)."""
        model_output, extra = _split_model_output(model(x, t, **(model_kwargs or {})))
        nd = x.ndim
        model_variance = self._extract("posterior_variance", t, nd) * torch.ones_like(x)
        model_log_variance = (self._extract("posterior_log_variance_clipped", t, nd)
                              * torch.ones_like(x))
        pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        if clip_denoised:
            pred_xstart = torch.clamp(pred_xstart, -1.0, 1.0)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart,
                "extra": extra}

    def _channel(self, arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        # channels-last: scale/bias broadcast over the leading axes
        return torch.as_tensor(arr, dtype=torch.float32, device=x.device).reshape(
            (1,) * (x.ndim - 1) + (-1,))

    def training_losses(self, model: Callable, x_start: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor, model_kwargs: Optional[Dict[str, Any]] = None,
                        use_cd_xyz_loss: Union[bool, torch.Tensor] = False
                        ) -> Dict[str, torch.Tensor]:
        """Per-sample losses at timesteps t for the epsilon / mse configuration: ``mse`` =
        mean_flat((noise - eps_hat)^2), and with ``use_cd_xyz_loss`` (a bool or a tensor
        flag, the chamfer curriculum's gate) ``c_dist`` = flag * sqrt(alpha_bar_t) *
        chamfer_xyz(x0_hat, x0), x0_hat implied by eps_hat; ``loss`` is their sum."""
        x_start = self.scale_channels(x_start)
        x_t = self.q_sample(x_start, t, noise)
        model_output, _ = _split_model_output(model(x_t, t, **(model_kwargs or {})))
        terms = {"mse": mean_flat((noise - model_output) ** 2)}
        terms["loss"] = terms["mse"]
        if use_cd_xyz_loss is not False:
            rc_scale = self._extract("sqrt_alphas_cumprod", t, 1)
            x_start_pred = self._predict_xstart_from_eps(x_t, t, model_output)
            cd = rc_scale * chamfer_distance_xyz(x_start_pred, x_start)
            gate = torch.as_tensor(use_cd_xyz_loss, dtype=cd.dtype, device=cd.device)
            terms["c_dist"] = gate * cd
            terms["loss"] = terms["loss"] + terms["c_dist"]
        return terms

    def scale_channels(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_scales is not None:
            x = x * self._channel(self.channel_scales, x)
        if self.channel_biases is not None:
            x = x + self._channel(self.channel_biases, x)
        return x

    def unscale_channels(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_biases is not None:
            x = x - self._channel(self.channel_biases, x)
        if self.channel_scales is not None:
            x = x / self._channel(self.channel_scales, x)
        return x


def diffusion_from_betas(schedule: str = "linear", timesteps: int = 1000,
                         **kwargs) -> GaussianDiffusion:
    """A GaussianDiffusion over the named schedule (no respacing)."""
    return GaussianDiffusion(betas=get_named_beta_schedule(schedule, timesteps), **kwargs)
