"""Karras (EDM) sigma-space solvers for a DDPM model, as Python loops.

Counterpart of :mod:`pcdiff.diffusion.karras` for the flagship sampler: the sigma grid,
the sigma -> t map, the stateful denoiser adaptors, ``sample_heun`` and
``sample_heun_reuse``, and guidance-interval CFG. Each ``lax.scan`` of the JAX package is
a Python loop here with the same arithmetic: scalar sigma arithmetic is float32 (numpy
float32 scalars), tensors are float32.

Stateful denoiser contract::

    denoise_fn(x, sigma_batch, state) -> (denoised_x0, new_state)

where ``state`` is the RIN self-conditioning latent (or None). ``s_churn`` noise
injection is not ported yet; the flagship sampler runs with ``s_churn = 0``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .gaussian import GaussianDiffusion

__all__ = [
    "get_sigmas_karras",
    "sigma_to_t",
    "gaussian_denoise_fn",
    "guided_denoise_fn",
    "sample_heun",
    "sample_heun_reuse",
    "half_model_kwargs",
    "gi_segment_runs",
    "cond_segment_denoise_fn",
    "sample_guided_interval",
]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], Tuple[torch.Tensor, Any]]


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    """The rho-spaced noise schedule of Karras et al. (2022) in float64, with a final 0."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.append(sigmas, 0.0)


def to_d(x: torch.Tensor, sigma: np.float32, denoised: torch.Tensor) -> torch.Tensor:
    """The Karras ODE derivative dx/dsigma for a scalar sigma."""
    return (x - denoised) / float(sigma)


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
    (the RIN latent) is the state, passed back as ``model_kwargs[state_key]``."""
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


def sample_heun(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                state: Any = None, s_churn: float = 0.0,
                final_to_zero: bool = True) -> Dict[str, Any]:
    """Karras Algorithm 2 (Heun): two-call steps, then a final Euler step to sigma = 0.
    The state is updated by both denoiser calls of a step, in order.
    ``final_to_zero=False`` runs a segment of a larger grid: every step is a two-call
    step and ``pred_xstart`` is None. Returns ``{"x", "pred_xstart", "state"}``."""
    if s_churn != 0.0:
        raise NotImplementedError("s_churn noise injection is not ported yet")
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    x = x_T

    def heun_step(x, state, i):
        sigma_i, sigma_next = sig[i], sig[i + 1]
        denoised, state = denoise_fn(x, _sigma_batch(sigma_i, x), state)
        d = to_d(x, sigma_i, denoised)
        dt = float(sigma_next - sigma_i)
        x_2 = x + d * dt
        denoised_2, state = denoise_fn(x_2, _sigma_batch(sigma_next, x), state)
        d_2 = to_d(x_2, sigma_next, denoised_2)
        return x + (d + d_2) / 2.0 * dt, state

    for i in range(n if not final_to_zero else n - 1):
        x, state = heun_step(x, state, i)
    if not final_to_zero:
        return {"x": x, "pred_xstart": None, "state": state}
    sigma_i = sig[n - 1]
    denoised, state = denoise_fn(x, _sigma_batch(sigma_i, x), state)
    x = x + to_d(x, sigma_i, denoised) * float(0.0 - sigma_i)
    return {"x": x, "pred_xstart": denoised, "state": state}


def sample_heun_reuse(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                      state: Any = None, s_churn: float = 0.0,
                      final_to_zero: bool = True) -> Dict[str, Any]:
    """Heun with past-score reuse: each interior step's predictor slope reuses the previous
    corrector's denoised prediction, re-anchored at the accepted x, so a step costs one
    denoiser call (``n + 1`` calls for ``n`` steps). Step 0 is a full two-call Heun step
    and the final step to sigma = 0 a fresh-call Euler step, as in
    :func:`pcdiff.diffusion.karras.sample_heun_reuse`."""
    if s_churn != 0.0:
        raise NotImplementedError("heun_reuse requires s_churn == 0")
    n = len(sigmas) - 1
    sig = np.asarray(sigmas, dtype=np.float32)
    x = x_T
    if n >= (2 if final_to_zero else 1):
        sigma0, sigma1 = sig[0], sig[1]
        denoised, state = denoise_fn(x, _sigma_batch(sigma0, x), state)
        d = to_d(x, sigma0, denoised)
        dt = float(sigma1 - sigma0)
        x_2 = x + d * dt
        den_prev, state = denoise_fn(x_2, _sigma_batch(sigma1, x), state)
        d_2 = to_d(x_2, sigma1, den_prev)
        x = x + (d + d_2) / 2.0 * dt
        for i in range(1, n - 1 if final_to_zero else n):
            sigma_i, sigma_next = sig[i], sig[i + 1]
            d = to_d(x, sigma_i, den_prev)  # reused score, fresh anchor
            dt = float(sigma_next - sigma_i)
            x_2 = x + d * dt
            den_prev, state = denoise_fn(x_2, _sigma_batch(sigma_next, x), state)
            d_2 = to_d(x_2, sigma_next, den_prev)
            x = x + (d + d_2) / 2.0 * dt
    if not final_to_zero:
        return {"x": x, "pred_xstart": None, "state": state}
    sigma_i = sig[n - 1]
    denoised, state = denoise_fn(x, _sigma_batch(sigma_i, x), state)
    x = x + to_d(x, sigma_i, denoised) * float(0.0 - sigma_i)
    return {"x": x, "pred_xstart": denoised, "state": state}


_SAMPLERS = {"heun": sample_heun, "heun_reuse": sample_heun_reuse}


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
                           sampler: str = "heun_reuse",
                           cond_batch: Optional[int] = None) -> Dict[str, Any]:
    """CFG restricted to a sigma interval (arXiv:2404.07724): steps whose anchor sigma
    lies in ``[lo, hi]`` call the guided 2B-row denoiser, the others the conditional
    branch alone at B rows. The grid splits into static segments, each solved by
    ``sampler`` with ``final_to_zero`` on the last one. ``state`` covers the 2B rows."""
    runs = gi_segment_runs(sigmas, guidance_interval)
    n = len(sigmas) - 1
    b = int(cond_batch if cond_batch is not None else x_T.shape[0])
    cond_segment_denoise = cond_segment_denoise_fn(denoise_cond, b)
    solver = _SAMPLERS[sampler]
    x, out = x_T, None
    for first, last, cfg_on in runs:
        out = solver(denoise_cfg if cfg_on else cond_segment_denoise, x,
                     sigmas[first:last + 1], state=state, final_to_zero=(last == n))
        x, state = out["x"], out["state"]
    return out
