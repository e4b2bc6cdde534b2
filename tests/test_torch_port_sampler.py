"""The port's Karras sampler against the JAX package's, on the CPU in fp32.

``sigma_to_t`` must equal JAX exactly (a timestep one off is another time embedding).
The trajectories run a tiny TwoStreamDenoiser with the same parameters on both sides,
CFG scale 3 as one 2B-row call, from the same x_T (numpy, seeded): ``sample_heun`` with
the guidance interval off, and ``sample_guided_interval`` with ``heun_reuse`` on a grid
that has both guided and conditional-only segments. Tolerance 1e-4: fp32 model
differences (1e-5 class) carried through the solver's steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.diffusion import karras as jk
from pcdiff.models import attention as jattn
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff.models.wrapper import BoundTwoStream as JBound
from pcdiff_torch.core import params_from_flax
from pcdiff_torch.diffusion import diffusion_from_betas as tdiffusion
from pcdiff_torch.diffusion import karras as tk
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.models.wrapper import BoundTwoStream as TBound

torch.set_num_threads(2)

TINY = dict(num_points=16, num_latents=4, latent_dim=32, x_dim=32, num_blocks=1,
            num_compute_layers=1, num_heads=4, num_classes=10,
            active_modalities=("class", "view"))
B = 2


@pytest.mark.parametrize("steps,sigma_max", [(64, 120.0), (32, 80.0)])
def test_sigma_to_t_exact(steps, sigma_max):
    sig = jk.get_sigmas_karras(steps, 1e-3, sigma_max)
    np.testing.assert_array_equal(tk.get_sigmas_karras(steps, 1e-3, sigma_max), sig)
    s32 = sig.astype(np.float32)
    want = np.asarray(jk.sigma_to_t(jdiffusion("linear", 1000), jnp.asarray(s32)))
    got = tk.sigma_to_t(tdiffusion("linear", 1000), torch.from_numpy(s32)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tk.gi_segment_runs(sig, (0.1, 10.0)) == jk.gi_segment_runs(sig, (0.1, 10.0))


@pytest.fixture(scope="module")
def pair():
    """The same tiny model on both sides, bound with its sampling hooks, and the CFG
    kwargs both samplers build from one conditioning batch."""
    jattn.set_ln_dense_fusion("on")
    rng = np.random.default_rng(3)
    batch = dict(class_labels=rng.integers(0, 10, (B,)).astype(np.int32),
                 viewpoints=rng.standard_normal((B, 3)).astype(np.float32))
    jmod = JTwoStream(**TINY)
    x0 = np.zeros((B, TINY["num_points"], 3), np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x0, np.zeros(B, np.int32),
                            **batch)["params"]
    flat = {}
    for path, sd in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        flat[path] = {"kernel": z / np.sqrt(np.prod(sd.shape[:-1])), "scale": 1 + 0.1 * z,
                      "bias": 0.1 * z}.get(path[-1], 0.3 * z)
    params = traverse_util.unflatten_dict(flat)
    tmod = TTwoStream(**TINY, device="cpu").eval()
    tmod.load_state_dict(params_from_flax(params), strict=True)
    jbound, tbound = JBound(jmod, {"params": params}), TBound(tmod)
    jkw = jbound.cfg_model_kwargs(B, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tkw = tbound.cfg_model_kwargs(B, {k: torch.from_numpy(v) for k, v in batch.items()})
    x_T = rng.standard_normal((B, TINY["num_points"], 3)).astype(np.float32) * 120.0
    yield jbound, tbound, jkw, tkw, x_T
    jattn.set_ln_dense_fusion("auto")


def _close(t_out, j_out, tol=1e-4):
    for key in ("x", "pred_xstart"):
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=tol, atol=tol, err_msg=key)


def test_cfg_kwargs_match(pair):
    _, _, jkw, tkw, _ = pair
    np.testing.assert_allclose(tkw["cond_tokens"].numpy(), np.asarray(jkw["cond_tokens"]),
                               rtol=1e-5, atol=1e-5)
    assert torch.count_nonzero(tkw["cond_tokens"][B:]) == 0


def test_heun_trajectory(pair):
    jbound, tbound, jkw, tkw, x_T = pair
    sigmas = jk.get_sigmas_karras(6, 1e-3, 120.0)
    jd, td = jdiffusion("linear", 1000), tdiffusion("linear", 1000)
    jden = jk.guided_denoise_fn(jk.gaussian_denoise_fn(jbound, jd, model_kwargs=jkw), 3.0)
    tden = tk.guided_denoise_fn(tk.gaussian_denoise_fn(tbound, td, model_kwargs=tkw), 3.0)
    want = jk.sample_heun(jden, jnp.asarray(x_T), sigmas, jax.random.PRNGKey(0),
                          state=jbound.init_latent(2 * B))
    tbound.calls = 0
    with torch.no_grad():
        got = tk.sample_heun(tden, torch.from_numpy(x_T), sigmas,
                             state=tbound.init_latent(2 * B))
    _close(got, want)
    assert tbound.calls == 2 * (len(sigmas) - 2) + 1


def test_guided_interval_heun_reuse_trajectory(pair):
    jbound, tbound, jkw, tkw, x_T = pair
    sigmas = jk.get_sigmas_karras(8, 1e-3, 120.0)
    gi = (0.1, 10.0)
    runs = tk.gi_segment_runs(sigmas, gi)
    assert {on for _, _, on in runs} == {True, False} and len(runs) == 3
    jd, td = jdiffusion("linear", 1000), tdiffusion("linear", 1000)
    jcfg = jk.guided_denoise_fn(jk.gaussian_denoise_fn(jbound, jd, model_kwargs=jkw), 3.0)
    tcfg = tk.guided_denoise_fn(tk.gaussian_denoise_fn(tbound, td, model_kwargs=tkw), 3.0)
    jcond = jk.gaussian_denoise_fn(jbound, jd, model_kwargs=jk.half_model_kwargs(jkw, B))
    tcond = tk.gaussian_denoise_fn(tbound, td, model_kwargs=tk.half_model_kwargs(tkw, B))
    want = jk.sample_guided_interval(
        jcond, jcfg, jnp.asarray(x_T), sigmas, jax.random.PRNGKey(0),
        state=jbound.init_latent(2 * B), guidance_interval=gi, sampler="heun_reuse",
        cond_batch=B)
    tbound.calls = 0
    with torch.no_grad():
        got = tk.sample_guided_interval(tcond, tcfg, torch.from_numpy(x_T), sigmas,
                                        state=tbound.init_latent(2 * B), guidance_interval=gi,
                                        sampler="heun_reuse", cond_batch=B)
    _close(got, want)
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               rtol=1e-4, atol=1e-4)
    assert tbound.calls == sum(b - a + 1 for a, b, _ in runs)  # n + 1 per segment
