"""Gaussian (DDPM) diffusion over precomputed tables.

Counterpart of :mod:`pcdiff.diffusion.gaussian`:

- the coefficient tables are computed once in float64 numpy and gathered as float32;
- ``model_mean_type`` in {epsilon, x_start, x_prev}, ``model_var_type`` in {fixed_small,
  fixed_large, learned, learned_range}, ``loss_type`` in {mse, rescaled_mse, kl,
  rescaled_kl}, with the learned variance trained through the variational bound on a
  detached mean;
- the chamfer auxiliary losses scaled by ``sqrt(alpha_bar_t)``;
- ancestral and DDIM sampling loops, the variational bound in bits per dimension, and
  ``SpacedDiffusion`` timestep respacing.

Layout is channels-last ([B, N, C]): channel scales and biases and the learned-variance
split act on the last axis. Each ``lax.scan`` of the JAX package is a Python loop here;
every normal comes from the caller's generator through :func:`._noise.normal`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..geometry.ops import chamfer_distance_color, chamfer_distance_xyz
from . import _noise
from .schedules import get_named_beta_schedule, space_timesteps

__all__ = [
    "GaussianDiffusion",
    "SpacedDiffusion",
    "diffusion_from_betas",
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
]

MEAN_TYPES = ("epsilon", "x_start", "x_prev")
VAR_TYPES = ("fixed_small", "fixed_large", "learned", "learned_range")
LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes -> [B]."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _tensors(*args):
    """The arguments as float32 tensors on the device of the first tensor among them."""
    ref = next(a for a in args if isinstance(a, torch.Tensor))
    return [a if isinstance(a, torch.Tensor)
            else torch.as_tensor(a, dtype=torch.float32, device=ref.device) for a in args]


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), broadcasting all arguments."""
    mean1, logvar1, mean2, logvar2 = _tensors(mean1, logvar1, mean2, logvar2)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh-based fast approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretised to 1/255 bins on [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def _split_model_output(out: Any) -> Tuple[torch.Tensor, Any]:
    """Normalise a model output to (array, extra)."""
    if isinstance(out, tuple):
        return out[0], (out[1] if len(out) == 2 else out[1:])
    return out, None


def _device(generator: Optional[torch.Generator], device):
    """Where a loop draws its first noise: ``device`` if given, else the generator's, else
    the card (:func:`resolve_device`'s default, which raises with no card present)."""
    if device is not None:
        return resolve_device(device)
    return generator.device if generator is not None else resolve_device()


class GaussianDiffusion:
    """Diffusion-process coefficient tables plus the sampling and loss functions over
    them. Instances hold float64 numpy tables and their float32 copies per device."""

    def __init__(self, *, betas: Sequence[float], model_mean_type: str = "epsilon",
                 model_var_type: str = "fixed_small", loss_type: str = "mse",
                 discretized_t0: bool = False,
                 channel_scales: Optional[np.ndarray] = None,
                 channel_biases: Optional[np.ndarray] = None):
        for value, allowed, what in ((model_mean_type, MEAN_TYPES, "model_mean_type"),
                                     (model_var_type, VAR_TYPES, "model_var_type"),
                                     (loss_type, LOSS_TYPES, "loss_type")):
            if value not in allowed:
                raise ValueError(f"{what} must be one of {allowed}, not {value!r}")
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.discretized_t0 = discretized_t0
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
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
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
        # "fixed_large" variance tables (better decoder likelihood at t=0)
        self.fixed_large_variance = np.append(self.posterior_variance[1], betas[1:])
        self.fixed_large_log_variance = np.log(self.fixed_large_variance)
        # derived tables, each computed in float64 before its float32 gather
        self.one_minus_alphas_cumprod = 1.0 - self.alphas_cumprod
        self.log_betas = np.log(betas)
        self.recip_posterior_mean_coef1 = 1.0 / self.posterior_mean_coef1
        self.posterior_mean_coef_ratio = self.posterior_mean_coef2 / self.posterior_mean_coef1
        self._device_tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    # ---------------------------------------------------------------- tables

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

    def get_sigmas(self, t: torch.Tensor) -> torch.Tensor:
        return self._extract("sqrt_recipm1_alphas_cumprod", t, t.ndim)

    # -------------------------------------------------------------- q-process

    def q_mean_variance(self, x_start: torch.Tensor, t: torch.Tensor):
        """Moments of q(x_t | x_0)."""
        nd = x_start.ndim
        return (self._extract("sqrt_alphas_cumprod", t, nd) * x_start,
                self._extract("one_minus_alphas_cumprod", t, nd),
                self._extract("log_one_minus_alphas_cumprod", t, nd))

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

    # -------------------------------------------------------------- p-process

    def p_mean_variance(self, model: Callable, x: torch.Tensor, t: torch.Tensor,
                        clip_denoised: bool = False,
                        denoised_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                        model_kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Moments of p(x_{t-1} | x_t) plus the model's x_0 prediction: a dict with mean /
        variance / log_variance / pred_xstart / extra (the model's tuple extra)."""
        model_output, extra = _split_model_output(model(x, t, **(model_kwargs or {})))
        nd = x.ndim
        if self.model_var_type in ("learned", "learned_range"):
            c = x.shape[-1]
            if model_output.shape[-1] != 2 * c:
                raise ValueError(f"a learned variance needs {2 * c} output channels, "
                                 f"got {model_output.shape[-1]}")
            model_output, model_var_values = torch.split(model_output, c, dim=-1)
            if self.model_var_type == "learned":
                model_log_variance = model_var_values
            else:
                min_log = self._extract("posterior_log_variance_clipped", t, nd)
                max_log = self._extract("log_betas", t, nd)
                frac = (model_var_values + 1.0) / 2.0  # model output in [-1, 1]
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            var_name, logvar_name = {
                "fixed_large": ("fixed_large_variance", "fixed_large_log_variance"),
                "fixed_small": ("posterior_variance", "posterior_log_variance_clipped"),
            }[self.model_var_type]
            model_variance = self._extract(var_name, t, nd) * torch.ones_like(x)
            model_log_variance = self._extract(logvar_name, t, nd) * torch.ones_like(x)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            if clip_denoised:
                xs = torch.clamp(xs, -1.0, 1.0)
            return xs

        if self.model_mean_type == "x_prev":
            pred_xstart = process_xstart(
                self._predict_xstart_from_xprev(x_t=x, t=t, xprev=model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == "x_start":
                pred_xstart = process_xstart(model_output)
            else:  # epsilon
                pred_xstart = process_xstart(
                    self._predict_xstart_from_eps(x_t=x, t=t, eps=model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart,
                "extra": extra}

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, nd) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        return (self._extract("recip_posterior_mean_coef1", t, nd) * xprev
                - self._extract("posterior_mean_coef_ratio", t, nd) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return ((self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t - pred_xstart)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, nd))

    # ----------------------------------------------------- guided conditioning

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """Shift the mean by variance * grad(log p(y|x)) (Sohl-Dickstein)."""
        gradient = cond_fn(x, t, **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """Condition the implied score function (Song et al. 2020)."""
        alpha_bar = self._extract("alphas_cumprod", t, x.ndim)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1.0 - alpha_bar) * cond_fn(x, t, **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # ------------------------------------------------------------- ancestral

    def p_sample(self, model: Callable, x: torch.Tensor, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None, clip_denoised: bool = False,
                 denoised_fn=None, cond_fn=None, model_kwargs=None) -> Dict[str, torch.Tensor]:
        """One ancestral step: sample x_{t-1} given x_t."""
        out = self.p_mean_variance(model, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        noise = _noise.normal(x.shape, generator, x.device, x.dtype)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs=model_kwargs)
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _loop(self, step, shape, generator, noise, device, progressive):
        """Run ``step(x, t_batch) -> {"sample", "pred_xstart"}`` from t = T-1 down to 0,
        from ``noise`` or fresh normals."""
        dev = _device(generator, device)
        x = noise if noise is not None else _noise.normal(shape, generator, dev)
        samples, preds = [], []
        for t_scalar in range(self.num_timesteps - 1, -1, -1):
            t_batch = torch.full((shape[0],), t_scalar, dtype=torch.long, device=x.device)
            out = step(x, t_batch)
            x = out["sample"]
            if progressive:
                samples.append(x)
                preds.append(out["pred_xstart"])
        if progressive:
            return {"sample": torch.stack(samples), "pred_xstart": torch.stack(preds)}
        return x

    def p_sample_loop(self, model: Callable, shape: Sequence[int],
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, clip_denoised: bool = False,
                      denoised_fn=None, cond_fn=None, model_kwargs=None,
                      progressive: bool = False, device=None):
        """The full ancestral chain. Returns the final sample, or with ``progressive`` a
        dict of the per-step ``sample`` and ``pred_xstart`` stacked on a leading axis (t =
        T-1 first)."""
        def step(x, t):
            return self.p_sample(model, x, t, generator, clip_denoised=clip_denoised,
                                 denoised_fn=denoised_fn, cond_fn=cond_fn,
                                 model_kwargs=model_kwargs)
        return self._loop(step, shape, generator, noise, device, progressive)

    # ------------------------------------------------------------------ DDIM

    def ddim_sample(self, model: Callable, x: torch.Tensor, t: torch.Tensor,
                    generator: Optional[torch.Generator] = None, clip_denoised: bool = False,
                    denoised_fn=None, cond_fn=None, model_kwargs=None,
                    eta: float = 0.0) -> Dict[str, torch.Tensor]:
        """One DDIM step (``eta = 0`` is deterministic and draws nothing)."""
        out = self.p_mean_variance(model, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._extract("alphas_cumprod", t, nd)
        alpha_bar_prev = self._extract("alphas_cumprod_prev", t, nd)
        sigma = (eta * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar))
                 * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1.0 - alpha_bar_prev - sigma ** 2) * eps)
        sample = mean_pred
        if eta != 0.0:
            noise = _noise.normal(x.shape, generator, x.device, x.dtype)
            nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
            sample = mean_pred + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model: Callable, x: torch.Tensor, t: torch.Tensor,
                            clip_denoised: bool = False, denoised_fn=None,
                            model_kwargs=None, eta: float = 0.0) -> Dict[str, torch.Tensor]:
        """One reverse-ODE (encoding) DDIM step; requires ``eta = 0``."""
        if eta != 0.0:
            raise ValueError("the reverse ODE is deterministic: eta must be 0")
        out = self.p_mean_variance(model, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        nd = x.ndim
        eps = ((self._extract("sqrt_recip_alphas_cumprod", t, nd) * x - out["pred_xstart"])
               / self._extract("sqrt_recipm1_alphas_cumprod", t, nd))
        alpha_bar_next = self._extract("alphas_cumprod_next", t, nd)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1.0 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model: Callable, shape: Sequence[int],
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None, clip_denoised: bool = False,
                         denoised_fn=None, cond_fn=None, model_kwargs=None, eta: float = 0.0,
                         progressive: bool = False, device=None):
        """The full DDIM chain, as :meth:`p_sample_loop`."""
        def step(x, t):
            return self.ddim_sample(model, x, t, generator, clip_denoised=clip_denoised,
                                    denoised_fn=denoised_fn, cond_fn=cond_fn,
                                    model_kwargs=model_kwargs, eta=eta)
        return self._loop(step, shape, generator, noise, device, progressive)

    # ------------------------------------------------------------------- VLB

    def _vb_terms_bpd(self, model, x_start, x_t, t, clip_denoised=False,
                      model_kwargs=None) -> Dict[str, Any]:
        """Per-sample variational-bound term at timestep t, in bits."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        if not self.discretized_t0:
            decoder_nll = torch.zeros_like(decoder_nll)
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"], "extra": out["extra"]}

    # ---------------------------------------------------------------- losses

    def training_losses(self, model: Callable, x_start: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor, model_kwargs: Optional[Dict[str, Any]] = None,
                        use_cd_xyz_loss: Union[bool, torch.Tensor] = False,
                        use_cd_color_loss: Union[bool, torch.Tensor] = False
                        ) -> Dict[str, torch.Tensor]:
        """Per-sample training losses at timesteps t. ``kl``/``rescaled_kl``: the
        variational bound alone. ``mse``/``rescaled_mse``: the mean-squared error to the
        mean type's target, plus with a learned variance the bound's term ``vb`` through a
        detached mean (scaled by T / 1000 under ``rescaled_mse``). The chamfer terms
        (epsilon prediction only) are gated by ``use_cd_*_loss``, a bool or a tensor flag
        (the chamfer curriculum), and scaled by sqrt(alpha_bar_t)."""
        model_kwargs = model_kwargs or {}
        x_start = self.scale_channels(x_start)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}

        if self.loss_type in ("kl", "rescaled_kl"):
            vb = self._vb_terms_bpd(model, x_start=x_start, x_t=x_t, t=t,
                                    clip_denoised=False, model_kwargs=model_kwargs)
            terms["loss"] = vb["output"]
            if self.loss_type == "rescaled_kl":
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output, extra = _split_model_output(model(x_t, t, **model_kwargs))
        if self.model_var_type in ("learned", "learned_range"):
            c = x_t.shape[-1]
            if model_output.shape[-1] != 2 * c:
                raise ValueError(f"a learned variance needs {2 * c} output channels, "
                                 f"got {model_output.shape[-1]}")
            model_output, model_var_values = torch.split(model_output, c, dim=-1)
            # learn the variance through the bound without letting it move the mean
            frozen = torch.cat([model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(
                model=lambda *_a, **_k: frozen, x_start=x_start, x_t=x_t, t=t,
                clip_denoised=False)["output"]
            if self.loss_type == "rescaled_mse":
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.model_mean_type == "x_prev":
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == "x_start":
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]

        if isinstance(extra, dict) and "losses" in extra:
            for k, (loss, scale) in extra["losses"].items():
                terms[k] = loss
                terms["loss"] = terms["loss"] + loss * scale

        if self.model_mean_type == "epsilon" and (
                use_cd_xyz_loss is not False or use_cd_color_loss is not False):
            rc_scale = self._extract("sqrt_alphas_cumprod", t, 1)
            x_start_pred = self._predict_xstart_from_eps(x_t, t, model_output)
            for flag, name, fn in ((use_cd_xyz_loss, "c_dist", chamfer_distance_xyz),
                                   (use_cd_color_loss, "c_dist_color",
                                    chamfer_distance_color)):
                if flag is False:
                    continue
                cd = rc_scale * fn(x_start_pred, x_start)
                gate = torch.as_tensor(flag, dtype=cd.dtype, device=cd.device)
                terms[name] = gate * cd
                terms["loss"] = terms["loss"] + terms[name]
        return terms

    def _prior_bpd(self, x_start: torch.Tensor) -> torch.Tensor:
        """Prior KL term of the bound in bits per dimension."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)
        return mean_flat(kl_prior) / math.log(2.0)

    def calc_bpd_loop(self, model: Callable, x_start: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      clip_denoised: bool = False, model_kwargs=None
                      ) -> Dict[str, torch.Tensor]:
        """The whole chain's bound, t = T-1 down to 0, one fresh noise a step:
        ``total_bpd``, ``prior_bpd``, and per step [B, T] ``vb``, ``xstart_mse``, ``mse``."""
        b = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for t_scalar in range(self.num_timesteps - 1, -1, -1):
            t_batch = torch.full((b,), t_scalar, dtype=torch.long, device=x_start.device)
            noise = _noise.normal(x_start.shape, generator, x_start.device, x_start.dtype)
            x_t = self.q_sample(x_start, t_batch, noise)
            out = self._vb_terms_bpd(model, x_start=x_start, x_t=x_t, t=t_batch,
                                     clip_denoised=clip_denoised, model_kwargs=model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t_batch, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb_t = torch.stack(vb, dim=1)  # [B, T]
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb_t.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd,
                "vb": vb_t, "xstart_mse": torch.stack(xstart_mse, dim=1),
                "mse": torch.stack(mse, dim=1)}

    # -------------------------------------------------------- channel scaling

    def _channel(self, arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        # channels-last: scale/bias broadcast over the leading axes
        return torch.as_tensor(arr, dtype=torch.float32, device=x.device).reshape(
            (1,) * (x.ndim - 1) + (-1,))

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

    def unscale_out_dict(self, out: Dict[str, Any]) -> Dict[str, Any]:
        return {k: (self.unscale_channels(v) if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}


class SpacedDiffusion(GaussianDiffusion):
    """A process that keeps some timesteps of a base process: rescaled betas over the kept
    steps, and the model's timesteps mapped back through ``timestep_map``."""

    def __init__(self, use_timesteps: Iterable[int], **kwargs):
        self.use_timesteps = set(use_timesteps)
        self.original_num_steps = len(kwargs["betas"])
        base = GaussianDiffusion(**kwargs)
        last_alpha_cumprod = 1.0
        new_betas = []
        self.timestep_map: list[int] = []
        for i, alpha_cumprod in enumerate(base.alphas_cumprod):
            if i in self.use_timesteps:
                new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
                last_alpha_cumprod = alpha_cumprod
                self.timestep_map.append(i)
        super().__init__(**dict(kwargs, betas=np.array(new_betas)))

    def map_timesteps(self, ts: torch.Tensor) -> torch.Tensor:
        """The base process's timesteps of this process's ``ts``."""
        key = ("timestep_map", ts.device)
        table = self._device_tables.get(key)
        if table is None:
            table = torch.as_tensor(self.timestep_map, dtype=torch.long, device=ts.device)
            self._device_tables[key] = table
        return table[ts]

    def _wrap_model(self, model: Callable) -> Callable:
        def wrapped(x, ts, **kw):
            return model(x, self.map_timesteps(ts), **kw)
        return wrapped

    def p_mean_variance(self, model, *args, **kwargs):
        return super().p_mean_variance(self._wrap_model(model), *args, **kwargs)

    def training_losses(self, model, *args, **kwargs):
        return super().training_losses(self._wrap_model(model), *args, **kwargs)

    def condition_mean(self, cond_fn, *args, **kwargs):
        return super().condition_mean(self._wrap_model(cond_fn), *args, **kwargs)

    def condition_score(self, cond_fn, *args, **kwargs):
        return super().condition_score(self._wrap_model(cond_fn), *args, **kwargs)


def diffusion_from_betas(schedule: str = "linear", timesteps: int = 1000, *,
                         respacing: Union[str, Sequence[int], None] = None,
                         **kwargs) -> GaussianDiffusion:
    """A process over the named schedule, respaced by ``respacing`` (see
    :func:`~.schedules.space_timesteps`) when given; ``kwargs`` go to the constructor."""
    betas = get_named_beta_schedule(schedule, timesteps)
    if respacing:
        return SpacedDiffusion(use_timesteps=space_timesteps(timesteps, respacing),
                               betas=betas, **kwargs)
    return GaussianDiffusion(betas=betas, **kwargs)
