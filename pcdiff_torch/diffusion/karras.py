"""Karras (EDM) sigma-space solvers, as Python loops.

Counterpart of :mod:`pcdiff.diffusion.karras`: the sigma grid, the sigma -> t map, EDM
preconditioning (:class:`KarrasDenoiser`), the stateful denoiser adaptors, the solvers
``heun`` (with ``s_churn`` noise injection), ``heun_reuse``, ``dpm`` and ``ancestral``,
guidance-interval CFG and :func:`karras_sample`. Each ``lax.scan`` of the JAX package is a
Python loop here with the same arithmetic: scalar sigma arithmetic is float32 (numpy
float32 scalars), tensors are float32. Every normal comes from the caller's generator
through :func:`._noise.normal`, and only where its scale is not zero (a churn step with
gamma > 0, an ancestral step with sigma_up > 0).

Stateful denoiser contract::

    denoise_fn(x, sigma_batch, state) -> (denoised_x0, new_state)

where ``state`` is the RIN self-conditioning latent (or None). With ``progressive`` each
solver also returns ``trajectory``: the per-step ``x``, ``pred_xstart`` and ``sigma``
stacked on a leading axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import _noise
from .gaussian import GaussianDiffusion, _device, _split_model_output, mean_flat

__all__ = [
    "get_sigmas_karras",
    "get_ancestral_step",
    "KarrasDenoiser",
    "sigma_to_t",
    "gaussian_denoise_fn",
    "guided_denoise_fn",
    "sample_heun",
    "sample_heun_reuse",
    "sample_dpm",
    "sample_euler_ancestral",
    "half_model_kwargs",
    "gi_segment_runs",
    "cond_segment_denoise_fn",
    "sample_guided_interval",
    "karras_sample",
]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], Tuple[torch.Tensor, Any]]
_F32 = np.float32


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    """The rho-spaced noise schedule of Karras et al. (2022) in float64, with a final 0."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.append(sigmas, 0.0)


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """The Karras ODE derivative dx/dsigma, sigma one a row. A tensor divisor keeps the
    division exact on the card, where a Python-float divisor becomes a multiplication by
    its reciprocal, a last bit off."""
    return (x - denoised) / _append_dims(sigma, x.ndim)


def get_ancestral_step(sigma_from, sigma_to):
    """(sigma_down, sigma_up) of an ancestral step from sigma_from to sigma_to, for float32
    scalars or tensors."""
    sqrt = torch.sqrt if isinstance(sigma_from, torch.Tensor) else np.sqrt
    sigma_up = sqrt(sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / sigma_from ** 2)
    sigma_down = sqrt(sigma_to ** 2 - sigma_up ** 2)
    return sigma_down, sigma_up


def _append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (target_ndim - x.ndim))


class KarrasDenoiser:
    """EDM preconditioning (c_skip, c_out, c_in) and the sigma-space training loss."""

    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def get_snr(self, sigmas):
        return sigmas ** -2

    def get_sigmas(self, sigmas):
        return sigmas

    def get_scalings(self, sigma):
        c_skip = self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)
        return c_skip, c_out, c_in

    def denoise(self, model, x_t, sigmas, **model_kwargs):
        """(the model's raw output, the denoised x_0) at per-row ``sigmas``."""
        nd = x_t.ndim
        c_skip, c_out, c_in = [_append_dims(c, nd) for c in self.get_scalings(sigmas)]
        rescaled_t = 1000 * 0.25 * torch.log(sigmas + 1e-44)
        model_output, _ = _split_model_output(model(c_in * x_t, rescaled_t, **model_kwargs))
        return model_output, c_out * model_output + c_skip * x_t

    def training_losses(self, model, x_start, sigmas, noise, model_kwargs=None):
        nd = x_start.ndim
        x_t = x_start + noise * _append_dims(sigmas, nd)
        c_skip, c_out, _ = [_append_dims(c, nd) for c in self.get_scalings(sigmas)]
        model_output, denoised = self.denoise(model, x_t, sigmas, **(model_kwargs or {}))
        target = (x_start - c_skip * x_t) / c_out
        terms = {"mse": mean_flat((model_output - target) ** 2),
                 "xs_mse": mean_flat((denoised - x_start) ** 2)}
        terms["loss"] = terms["mse"]
        return terms


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (constant extrapolation), op for op."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sigma_to_t(diffusion: GaussianDiffusion, sigma: torch.Tensor) -> torch.Tensor:
    """EDM sigma -> DDPM timestep: fp32 interpolation of alphas_cumprod -> t, truncated
    toward zero (the reference's ``interp1d`` + cast-to-long)."""
    alpha_cumprod = 1.0 / (sigma.float() ** 2 + 1.0)
    xp = diffusion.table("alphas_cumprod", sigma.device).flip(0)  # ascending
    fp = torch.arange(diffusion.num_timesteps - 1, -1, -1, dtype=torch.float32,
                      device=sigma.device)
    return _interp(alpha_cumprod, xp, fp).long()


def gaussian_denoise_fn(model, diffusion: GaussianDiffusion, clip_denoised: bool = True,
                        model_kwargs: Optional[Dict[str, Any]] = None,
                        state_key: str = "prev_latent") -> DenoiseFn:
    """A DDPM model + process as a stateful sigma-space denoiser; the model's tuple extra
    (the RIN latent) is the state, passed back as ``model_kwargs[state_key]``. Under a
    learned variance the process keeps the first C channels of the model's output."""
    model_kwargs = dict(model_kwargs or {})
    model_kwargs.pop(state_key, None)

    def denoise(x_t, sigmas, state):
        t = sigma_to_t(diffusion, sigmas)
        c_in = (1.0 / torch.sqrt(sigmas ** 2 + 1.0)).reshape((-1,) + (1,) * (x_t.ndim - 1))
        kwargs = dict(model_kwargs)
        if state is not None:
            kwargs[state_key] = state
        out = diffusion.p_mean_variance(model, x_t * c_in, t, clip_denoised=clip_denoised,
                                        model_kwargs=kwargs)
        return out["pred_xstart"], (out["extra"] if out["extra"] is not None else state)

    return denoise


def guided_denoise_fn(denoise_fn: DenoiseFn, guidance_scale: float) -> DenoiseFn:
    """Classifier-free guidance as one 2B-row call of a denoiser whose conditioning kwargs
    are 2B-batched (conditional rows, then zeroed rows)."""

    def denoise(x, sigmas, state):
        x0_2, state = denoise_fn(torch.cat([x, x]), torch.cat([sigmas, sigmas]), state)
        cond_x0, uncond_x0 = torch.chunk(x0_2, 2, dim=0)
        return uncond_x0 + guidance_scale * (cond_x0 - uncond_x0), state

    return denoise


def _sigma_batch(sigma: np.float32, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), float(sigma), dtype=torch.float32, device=x.device)


def _gamma_for(sigma: np.float32, n_steps: int, s_churn: float, s_tmin: float,
               s_tmax: float) -> np.float32:
    """The churn factor at sigma: min(s_churn / n, sqrt(2) - 1) inside [s_tmin, s_tmax]."""
    gamma_const = min(s_churn / n_steps, 2 ** 0.5 - 1)
    in_range = _F32(s_tmin) <= sigma <= _F32(s_tmax)
    return _F32(gamma_const) if in_range else _F32(0.0)


def _churn(x: torch.Tensor, generator, sigma: np.float32, gamma: np.float32,
           s_noise: float) -> Tuple[torch.Tensor, np.float32]:
    """s_churn noise injection: (x + s_noise * eps * sqrt(sigma_hat^2 - sigma^2),
    sigma_hat = sigma (gamma + 1)); no draw where gamma is 0."""
    sigma_hat = sigma * (gamma + _F32(1.0))
    if gamma == 0:
        return x, sigma_hat
    eps = _noise.normal(x.shape, generator, x.device, x.dtype) * s_noise
    bump = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2, _F32(0.0)))
    return x + eps * float(bump), sigma_hat


class _Trajectory:
    """The per-step (x, pred_xstart, sigma) of a progressive solve."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.x, self.pred, self.sigma = [], [], []

    def add(self, x, pred, sigma) -> None:
        if self.enabled:
            self.x.append(x)
            self.pred.append(pred)
            self.sigma.append(float(sigma))

    def into(self, out: Dict[str, Any], like: torch.Tensor) -> Dict[str, Any]:
        if self.enabled:
            out["trajectory"] = {
                "x": torch.stack(self.x), "pred_xstart": torch.stack(self.pred),
                "sigma": torch.tensor(self.sigma, dtype=torch.float32, device=like.device)}
        return out


def sample_heun(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                generator: Optional[torch.Generator] = None, state: Any = None,
                s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                s_noise: float = 1.0, progressive: bool = False,
                final_to_zero: bool = True) -> Dict[str, Any]:
    """Karras Algorithm 2 (Heun): two-call steps, then a final Euler step to sigma = 0,
    each step first churned by ``s_churn`` (noise from ``generator``) where sigma lies in
    [s_tmin, s_tmax]. The state is updated by both denoiser calls of a step, in order.
    ``final_to_zero=False`` runs a segment of a larger grid: every step is a two-call
    step and ``pred_xstart`` is None. Returns ``{"x", "pred_xstart", "state"}``."""
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    traj = _Trajectory(progressive)
    x = x_T

    def churned(x, i):
        gamma = _gamma_for(sig[i], n, s_churn, s_tmin, s_tmax)
        return _churn(x, generator, sig[i], gamma, s_noise)

    for i in range(n if not final_to_zero else n - 1):
        x, sigma_hat = churned(x, i)
        sigma_next = sig[i + 1]
        s_hat, s_next = _sigma_batch(sigma_hat, x), _sigma_batch(sigma_next, x)
        denoised, state = denoise_fn(x, s_hat, state)
        d = to_d(x, s_hat, denoised)
        dt = float(sigma_next - sigma_hat)
        x_2 = x + d * dt
        denoised_2, state = denoise_fn(x_2, s_next, state)
        d_2 = to_d(x_2, s_next, denoised_2)
        x = x + (d + d_2) / 2.0 * dt
        traj.add(x, denoised, sig[i])
    if not final_to_zero:
        return traj.into({"x": x, "pred_xstart": None, "state": state}, x)
    x, sigma_hat = churned(x, n - 1)
    s_hat = _sigma_batch(sigma_hat, x)
    denoised, state = denoise_fn(x, s_hat, state)
    x = x + to_d(x, s_hat, denoised) * float(0.0 - sigma_hat)
    traj.add(x, denoised, sig[n - 1])
    return traj.into({"x": x, "pred_xstart": denoised, "state": state}, x)


def sample_heun_reuse(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                      generator: Optional[torch.Generator] = None, state: Any = None,
                      s_churn: float = 0.0, s_tmin: float = 0.0,
                      s_tmax: float = float("inf"), s_noise: float = 1.0,
                      progressive: bool = False, final_to_zero: bool = True
                      ) -> Dict[str, Any]:
    """Heun with past-score reuse: each interior step's predictor slope reuses the previous
    corrector's denoised prediction, re-anchored at the accepted x, so a step costs one
    denoiser call (``n + 1`` calls for ``n`` steps). Step 0 is a full two-call Heun step
    and the final step to sigma = 0 a fresh-call Euler step, as in
    :func:`pcdiff.diffusion.karras.sample_heun_reuse`. Requires ``s_churn == 0``."""
    if s_churn != 0.0:
        raise NotImplementedError("heun_reuse requires s_churn == 0")
    del generator, s_tmin, s_tmax, s_noise  # no churn, no draws
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    traj = _Trajectory(progressive)
    x = x_T
    if n >= (2 if final_to_zero else 1):
        sigma0, sigma1 = sig[0], sig[1]
        s_0, s_1 = _sigma_batch(sigma0, x), _sigma_batch(sigma1, x)
        denoised, state = denoise_fn(x, s_0, state)
        d = to_d(x, s_0, denoised)
        dt = float(sigma1 - sigma0)
        x_2 = x + d * dt
        den_prev, state = denoise_fn(x_2, s_1, state)
        d_2 = to_d(x_2, s_1, den_prev)
        x = x + (d + d_2) / 2.0 * dt
        traj.add(x, denoised, sigma0)
        s_i = s_1
        for i in range(1, n - 1 if final_to_zero else n):
            sigma_i, sigma_next = sig[i], sig[i + 1]
            s_next = _sigma_batch(sigma_next, x)
            d = to_d(x, s_i, den_prev)  # reused score, fresh anchor
            dt = float(sigma_next - sigma_i)
            x_2 = x + d * dt
            den_used = den_prev
            den_prev, state = denoise_fn(x_2, s_next, state)
            d_2 = to_d(x_2, s_next, den_prev)
            x = x + (d + d_2) / 2.0 * dt
            traj.add(x, den_used, sigma_i)
            s_i = s_next
    if not final_to_zero:
        return traj.into({"x": x, "pred_xstart": None, "state": state}, x)
    sigma_i = sig[n - 1]
    s_i = _sigma_batch(sigma_i, x)
    denoised, state = denoise_fn(x, s_i, state)
    x = x + to_d(x, s_i, denoised) * float(0.0 - sigma_i)
    traj.add(x, denoised, sigma_i)
    return traj.into({"x": x, "pred_xstart": denoised, "state": state}, x)


def sample_dpm(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
               generator: Optional[torch.Generator] = None, state: Any = None,
               s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
               s_noise: float = 1.0, progressive: bool = False) -> Dict[str, Any]:
    """DPM-Solver-2-style midpoint sampler: two calls a step, the second at the midpoint
    sigma ((sigma_hat^(1/3) + sigma_next^(1/3)) / 2)^3, which stays positive on the last
    step too; churned as :func:`sample_heun`. ``pred_xstart`` is the last step's first
    call's denoised."""
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    traj = _Trajectory(progressive)
    x = x_T
    denoised = torch.zeros_like(x_T)
    third = _F32(1 / 3)
    for i in range(n):
        gamma = _gamma_for(sig[i], n, s_churn, s_tmin, s_tmax)
        x, sigma_hat = _churn(x, generator, sig[i], gamma, s_noise)
        sigma_next = sig[i + 1]
        s_hat = _sigma_batch(sigma_hat, x)
        denoised, state = denoise_fn(x, s_hat, state)
        d = to_d(x, s_hat, denoised)
        root = (sigma_hat ** third + sigma_next ** third) / _F32(2.0)
        sigma_mid = root * root * root
        x_2 = x + d * float(sigma_mid - sigma_hat)
        s_mid = _sigma_batch(sigma_mid, x)
        denoised_2, state = denoise_fn(x_2, s_mid, state)
        d_2 = to_d(x_2, s_mid, denoised_2)
        x = x + d_2 * float(sigma_next - sigma_hat)
        traj.add(x, denoised, sig[i])
    return traj.into({"x": x, "pred_xstart": denoised, "state": state}, x)


def sample_euler_ancestral(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                           generator: Optional[torch.Generator] = None, state: Any = None,
                           progressive: bool = False) -> Dict[str, Any]:
    """Ancestral sampling with Euler steps: one call a step, an Euler step down to
    sigma_down, then fresh noise of scale sigma_up (none on the last step, where it is 0).
    ``pred_xstart`` is the final x, as in the JAX package."""
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    traj = _Trajectory(progressive)
    x = x_T
    for i in range(n):
        sigma_i, sigma_next = sig[i], sig[i + 1]
        s_i = _sigma_batch(sigma_i, x)
        denoised, state = denoise_fn(x, s_i, state)
        sigma_down, sigma_up = get_ancestral_step(sigma_i, sigma_next)
        d = to_d(x, s_i, denoised)
        x = x + d * float(sigma_down - sigma_i)
        if sigma_up != 0:
            x = x + _noise.normal(x.shape, generator, x.device, x.dtype) * float(sigma_up)
        traj.add(x, denoised, sigma_i)
    return traj.into({"x": x, "pred_xstart": x, "state": state}, x)


_SAMPLERS = {
    "heun": sample_heun,
    "heun_reuse": sample_heun_reuse,
    "dpm": sample_dpm,
    "ancestral": sample_euler_ancestral,
}
SOLVERS = tuple(_SAMPLERS) + ("heun_parallel",)


def half_model_kwargs(model_kwargs, batch_size: int):
    """The conditional half of 2B-batched CFG kwargs: any tensor with 2B leading rows is
    cut to its first B rows, everything else passes through."""

    def half(v):
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == 2 * batch_size:
            return v[:batch_size]
        return v

    return {k: half(v) for k, v in (model_kwargs or {}).items()}


def gi_segment_runs(sigmas: np.ndarray, guidance_interval: Tuple[float, float]):
    """``[(first_step, last_step_exclusive, cfg_on)]``: the contiguous runs of steps whose
    anchor sigma lies inside / outside ``[lo, hi]``."""
    lo, hi = guidance_interval
    n = len(sigmas) - 1
    use_cfg = [bool(lo <= float(sigmas[i]) <= hi) for i in range(n)]
    runs = []
    i = 0
    while i < n:
        j = i
        while j < n and use_cfg[j] == use_cfg[i]:
            j += 1
        runs.append((i, j, use_cfg[i]))
        i = j
    return runs


def cond_segment_denoise_fn(denoise_cond: DenoiseFn, batch_size: int) -> DenoiseFn:
    """A B-row conditional denoiser run against a 2B CFG state: it reads and writes the
    first B state rows and leaves the unconditional rows as they are."""

    def cond_segment_denoise(x, s, full_state):
        if full_state is None:
            return denoise_cond(x, s, None)
        x0, half = denoise_cond(x, s, full_state[:batch_size])
        return x0, torch.cat([half.to(full_state.dtype), full_state[batch_size:]])

    return cond_segment_denoise


def sample_guided_interval(denoise_cond: DenoiseFn, denoise_cfg: DenoiseFn,
                           x_T: torch.Tensor, sigmas: np.ndarray, *, state: Any = None,
                           guidance_interval: Tuple[float, float],
                           sampler: str = "heun_reuse", cond_batch: Optional[int] = None,
                           progressive: bool = False) -> Dict[str, Any]:
    """CFG restricted to a sigma interval (arXiv:2404.07724): steps whose anchor sigma
    lies in ``[lo, hi]`` call the guided 2B-row denoiser, the others the conditional
    branch alone at B rows. The grid splits into static segments, each solved by
    ``sampler`` (``heun`` or ``heun_reuse``, unchurned) with ``final_to_zero`` on the last
    one. ``state`` covers the 2B rows. ``progressive`` joins the segments' trajectories."""
    runs = gi_segment_runs(sigmas, guidance_interval)
    n = len(sigmas) - 1
    b = int(cond_batch if cond_batch is not None else x_T.shape[0])
    cond_segment_denoise = cond_segment_denoise_fn(denoise_cond, b)
    solver = _SAMPLERS[sampler]
    x, out = x_T, None
    trajectories = []
    for first, last, cfg_on in runs:
        out = solver(denoise_cfg if cfg_on else cond_segment_denoise, x,
                     sigmas[first:last + 1], state=state, final_to_zero=(last == n),
                     progressive=progressive)
        x, state = out["x"], out["state"]
        if progressive:
            trajectories.append(out["trajectory"])
    if progressive:
        out["trajectory"] = {k: torch.cat([t[k] for t in trajectories])
                             for k in ("x", "pred_xstart", "sigma")}
    return out


def _unscale(diffusion, out: Dict[str, Any], progressive: bool) -> Dict[str, Any]:
    """The solver's x and pred_xstart (and their trajectories) in the data's channels."""
    if isinstance(diffusion, GaussianDiffusion):
        out["x"] = diffusion.unscale_channels(out["x"])
        if out.get("pred_xstart") is not None:
            out["pred_xstart"] = diffusion.unscale_channels(out["pred_xstart"])
        if progressive:
            for k in ("x", "pred_xstart"):
                out["trajectory"][k] = diffusion.unscale_channels(out["trajectory"][k])
    return out


def karras_sample(diffusion, model, shape, steps: int,
                  generator: Optional[torch.Generator] = None, *,
                  clip_denoised: bool = True, model_kwargs: Optional[Dict[str, Any]] = None,
                  sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0,
                  sampler: str = "heun", s_churn: float = 0.0, s_tmin: float = 0.0,
                  s_tmax: float = float("inf"), s_noise: float = 1.0,
                  guidance_scale: float = 0.0,
                  guidance_interval: Optional[Tuple[float, float]] = None,
                  init_state: Any = None, progressive: bool = False,
                  parallel_options: Optional[Dict[str, Any]] = None,
                  device=None) -> Dict[str, Any]:
    """End-to-end Karras sampling of ``model`` under ``diffusion`` (a
    :class:`GaussianDiffusion` or a :class:`KarrasDenoiser`) from fresh noise of ``shape``
    times ``sigma_max``, every draw from ``generator`` on ``device`` (by default the
    generator's, else the card). With guidance, ``model_kwargs`` must already be 2B-batched (conditional rows
    then zeroed rows) and ``shape`` is the undoubled [B, N, C]; ``init_state`` (a
    self-conditioning model's) covers the 2B rows. ``heun_parallel`` takes
    ``parallel_options`` (``window``, ``tol``)."""
    sigmas = get_sigmas_karras(steps, sigma_min, sigma_max, rho)
    x_T = _noise.normal(shape, generator, _device(generator, device)) * sigma_max
    guided = guidance_scale not in (0.0, 1.0)

    def make_base(kw):
        if isinstance(diffusion, KarrasDenoiser):
            def base(x_t, s, state):
                _, denoised = diffusion.denoise(model, x_t, s, **(kw or {}))
                if clip_denoised:
                    denoised = torch.clamp(denoised, -1.0, 1.0)
                return denoised, state
            return base
        if isinstance(diffusion, GaussianDiffusion):
            return gaussian_denoise_fn(model, diffusion, clip_denoised=clip_denoised,
                                       model_kwargs=kw)
        raise NotImplementedError(type(diffusion))

    def make_denoise(kw):
        base = make_base(kw)
        return guided_denoise_fn(base, guidance_scale) if guided else base

    if guidance_interval is not None and guided:
        if sampler not in ("heun", "heun_reuse"):
            # heun_parallel revisits every step each Picard iteration, so there is no
            # per-step value to yield until convergence
            raise NotImplementedError("guidance_interval supports heun/heun_reuse only")
        if s_churn != 0.0:
            raise NotImplementedError("guidance_interval requires s_churn == 0")
        b = int(shape[0])
        out = sample_guided_interval(
            make_base(half_model_kwargs(model_kwargs, b)), make_denoise(model_kwargs), x_T,
            sigmas, state=init_state, guidance_interval=guidance_interval, sampler=sampler,
            cond_batch=b, progressive=progressive)
        return _unscale(diffusion, out, progressive)

    if sampler == "heun_parallel":
        from .parallel import solve_parallel

        if progressive:
            raise NotImplementedError("heun_parallel has no progressive mode")
        out = solve_parallel(make_denoise, model_kwargs, x_T, sigmas, guided=guided,
                             state=init_state, s_churn=s_churn,
                             parallel_options=parallel_options)
    else:
        kwargs = dict(state=init_state, progressive=progressive, generator=generator)
        if sampler != "ancestral":
            kwargs.update(s_churn=s_churn, s_tmin=s_tmin, s_tmax=s_tmax, s_noise=s_noise)
        out = _SAMPLERS[sampler](make_denoise(model_kwargs), x_T, sigmas, **kwargs)
    return _unscale(diffusion, out, progressive)
