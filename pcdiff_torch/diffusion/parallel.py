"""Parallel-in-time Karras sampling: Picard iteration over a window of Heun steps, on one
card (counterpart of :mod:`pcdiff.diffusion.parallel`).

The Heun recurrence in integral form, ``x_{i+1} = x_p + sum_{j=p..i} D_j(x_j, state_j)``
over a window of ``W`` steps from the frontier ``p``, is solved by fixed-point iteration
(ParaDiGMS, arXiv:2305.16317): each iteration evaluates every window position's drift at
once, so a sequential round is one denoiser call pair over ``W`` times the rows instead
of ``W`` call pairs. The frontier's update is exact, so it advances by at least one step
an iteration; with ``tol > 0`` it also skips positions whose iterate moved less than
``tol`` (relative to sqrt(sigma^2 + 0.25)); ``tol = 0`` re-derives ``sample_heun``.

Where the JAX package ``vmap``s the denoiser over the window, the port folds the window
into the batch: the denoiser is called on ``W * B`` rows, position-major, with one sigma
a row, and must have been built over model kwargs tiled by :func:`window_model_kwargs`.
A CFG denoiser (``guided_denoise_fn``) doubles those rows into a conditional and an
unconditional group, so a position's state of ``groups * B`` rows is laid out group by
group across the window (``groups`` = 2 under CFG, else 1). The frontier is read on the
host once an iteration.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .karras import DenoiseFn, to_d

__all__ = ["sample_heun_parallel", "solve_parallel", "window_model_kwargs"]


def _tile(v: torch.Tensor, window: int, groups: int) -> torch.Tensor:
    """[groups * B, ...] -> [groups * window * B, ...]: each group's rows, window times."""
    b = v.shape[0] // groups
    tail = tuple(v.shape[1:])
    return (v.reshape((groups, 1, b) + tail).expand((groups, window, b) + tail)
            .reshape((groups * window * b,) + tail))


def window_model_kwargs(model_kwargs: Optional[Dict[str, Any]], batch_size: int,
                        window: int, groups: int = 1) -> Dict[str, Any]:
    """Model kwargs for a denoiser called on a window of ``window`` positions: each tensor
    with ``groups * batch_size`` leading rows (``groups`` = 2 for CFG kwargs, conditional
    rows then zeroed rows) has each group's rows repeated ``window`` times; anything else
    passes through."""
    out = {}
    for k, v in (model_kwargs or {}).items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == groups * batch_size:
            v = _tile(v, window, groups)
        out[k] = v
    return out


def _to_window(states: torch.Tensor, groups: int) -> torch.Tensor:
    """[W, groups * B, ...] per-position states -> the window denoiser's [groups * W * B,
    ...] layout, group by group."""
    w, gb = states.shape[:2]
    tail = tuple(states.shape[2:])
    return (states.reshape((w, groups, gb // groups) + tail).transpose(0, 1)
            .reshape((w * gb,) + tail))


def _from_window(state: torch.Tensor, window: int, groups: int) -> torch.Tensor:
    """The inverse of :func:`_to_window`."""
    tail = tuple(state.shape[1:])
    b = state.shape[0] // (groups * window)
    return (state.reshape((groups, window, b) + tail).transpose(0, 1)
            .reshape((window, groups * b) + tail))


def _rows(b: int, v: torch.Tensor) -> torch.Tensor:
    """One value a window position -> one a row of the [W * B] window batch."""
    return v.repeat_interleave(b)


def sample_heun_parallel(denoise_fn: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray, *,
                         state: Any = None, window: int = 8, tol: float = 1e-3,
                         s_churn: float = 0.0, groups: int = 1, window_spec: Any = None,
                         mesh: Any = None) -> Dict[str, Any]:
    """The Picard-parallel Heun solve of ``sample_heun``'s grid from ``x_T`` [B, ...].
    ``denoise_fn`` takes ``min(window, n) * B`` rows (see the module's notes), ``state``
    (a tensor of ``groups * B`` rows, or None) is one position's state. Returns ``x``,
    ``pred_xstart``, ``state`` and ``parallel_iters`` (the sequential rounds taken, at
    most n). At ``tol > 0`` the state at accepted positions lags one iteration, as in the
    JAX package; at ``tol = 0`` it is exact. Sharding the window across cards
    (``window_spec``, ``mesh``) is not ported."""
    if window_spec is not None or mesh is not None:
        raise NotImplementedError("sharding the window across cards is not ported yet")
    if s_churn != 0.0:
        raise NotImplementedError(
            "parallel Heun requires s_churn=0 (stochastic churn would decouple the parallel "
            "and sequential trajectories)")
    n = len(sigmas) - 1
    w = min(window, n)
    b = x_T.shape[0]
    dev = x_T.device
    sig = torch.as_tensor(np.asarray(sigmas, dtype=np.float32), device=dev)
    sigma_i, sigma_next = sig[:-1], sig[1:]
    # the expected scale of x_{i+1}: noise level and the data's std (sigma_data 0.5)
    scale2 = sigma_next ** 2 + 0.25

    # X[i]: the iterate of x at grid index i; Dn[i]: position i's last denoised; S[i]:
    # position i's input state (the state after position i - 1)
    X = x_T.unsqueeze(0).repeat((n + 1,) + (1,) * x_T.dim())
    Dn = torch.zeros((n,) + tuple(x_T.shape), dtype=x_T.dtype, device=dev)
    S = None if state is None else state.unsqueeze(0).repeat((n + 1,) + (1,) * state.dim())
    lift = (-1,) + (1,) * (x_T.dim() - 1)

    p, iters = 0, 0
    while p < n:
        nv = min(w, n - p)
        cidx = torch.clamp(torch.arange(p, p + w, device=dev), max=n - 1)
        s_w, sn_w = sigma_i[cidx], sigma_next[cidx]
        is_last = sn_w == 0.0
        safe_next = torch.where(is_last, torch.ones_like(sn_w), sn_w)
        dt = sn_w - s_w
        x = X[cidx].reshape((w * b,) + tuple(x_T.shape[1:]))
        st = None if S is None else _to_window(S[cidx], groups)

        s_rows, next_rows = _rows(b, s_w), _rows(b, safe_next)
        dt_rows = _rows(b, dt).reshape(lift)
        denoised, st1 = denoise_fn(x, s_rows, st)
        d = to_d(x, s_rows, denoised)
        x_2 = x + d * dt_rows
        denoised_2, st2 = denoise_fn(x_2, next_rows, st1)
        d_2 = to_d(x_2, next_rows, denoised_2)
        drift = torch.where(_rows(b, is_last).reshape(lift), d * dt_rows,
                            (d + d_2) / 2.0 * dt_rows)

        drift = drift.reshape((w,) + tuple(x_T.shape))[:nv]
        new_x = X[p].unsqueeze(0) + torch.cumsum(drift, dim=0)  # x_{p+1..p+nv}
        old_x = X[p + 1:p + 1 + nv]
        err = ((new_x - old_x) ** 2).reshape(nv, -1).mean(dim=1)
        X[p + 1:p + 1 + nv] = new_x
        Dn[p:p + nv] = denoised.reshape((w,) + tuple(x_T.shape))[:nv]
        if S is not None:
            # the last step is a plain Euler step: it keeps the predictor's state
            keep1 = is_last.reshape((w,) + (1,) * state.dim())
            st_out = torch.where(keep1, _from_window(st1, w, groups),
                                 _from_window(st2, w, groups))
            S[p + 1:p + 1 + nv] = st_out[:nv].to(S.dtype)

        # the frontier is exact now; advance past the positions that also converged
        converged = err <= tol ** 2 * scale2[cidx[:nv]]
        converged[0] = True
        flags = converged.tolist()  # the iteration's one synchronisation
        advance = flags.index(False) if False in flags else nv
        p += advance
        iters += 1

    return {"x": X[n], "pred_xstart": Dn[n - 1], "state": state if S is None else S[n],
            "parallel_iters": iters}


def solve_parallel(make_denoise: Callable[[Dict[str, Any]], DenoiseFn],
                   model_kwargs: Optional[Dict[str, Any]], x_T: torch.Tensor,
                   sigmas: np.ndarray, *, guided: bool, state: Any = None,
                   s_churn: float = 0.0,
                   parallel_options: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``sample_heun_parallel`` over the denoiser ``make_denoise`` builds from the model
    kwargs tiled for the window (``parallel_options``: ``window``, default 8, ``tol``);
    ``guided``: the denoiser runs CFG over kwargs of two row groups."""
    opts = dict(parallel_options or {})
    window = min(int(opts.pop("window", 8)), len(sigmas) - 1)
    groups = 2 if guided else 1
    denoise = make_denoise(window_model_kwargs(model_kwargs, x_T.shape[0], window, groups))
    return sample_heun_parallel(denoise, x_T, sigmas, state=state, s_churn=s_churn,
                                window=window, groups=groups, **opts)
