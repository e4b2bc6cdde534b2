"""The port's solvers and multi-stage sampler against the JAX package's, on the CPU in fp32.

A toy stateful denoiser (``model(x, t, cond, prev_latent) -> (eps, latent)``, the same
numpy weights on both sides, a few small products so that the JAX package's scans compile
in a second) carries the solvers' arithmetic, CFG as one 2B-row call and the latent;
the tiny TwoStreamDenoiser, bound with its sampling hooks, holds ``heun_parallel``'s
window folded into the batch against the port's own sequential ``heun`` (which
tests/test_torch_port_sampler.py holds against the JAX package on that model). Every stochastic path is
fed the JAX package's own normals, made in its key-split order, through the port's one
noise seam (``pcdiff_torch.diffusion._noise.normal``); the port draws only where a
normal's scale is not zero, so the feeds leave out the JAX draws it multiplies by zero.
Deterministic parts (churn with ``s_noise = 0``, ``heun_parallel`` at ``tol = 0``) need
no feed. Tolerance 1e-4 for trajectories (fp32 differences of the 1e-5 class carried
through the solver's steps, as tests/test_torch_port_sampler.py): of each value, and in a
progressive trajectory also of its step's sigma (``_close_steps``); 1e-5 for the
conversions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.diffusion import karras as jk
from pcdiff.diffusion import sampler as jsampler
from pcdiff_torch.core import init_params
from pcdiff_torch.diffusion import _noise
from pcdiff_torch.diffusion import diffusion_from_betas as tdiffusion
from pcdiff_torch.diffusion import karras as tk
from pcdiff_torch.diffusion import sampler as tsampler
from pcdiff_torch.diffusion.parallel import sample_heun_parallel, window_model_kwargs
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.models.wrapper import BoundTwoStream as TBound

torch.set_num_threads(2)

TOL = 1e-4
TINY = dict(num_points=16, num_latents=4, latent_dim=32, x_dim=32, num_blocks=1,
            num_compute_layers=1, num_heads=4, num_classes=10,
            active_modalities=("class", "view"))
B = 2
SHAPE = (B, TINY["num_points"], 3)
STEPS = 4


class Draws:
    """A stand-in for the port's noise seam that hands out given arrays in order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, shape, generator, device, dtype=torch.float32):
        a = self.queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.fixture
def feed(monkeypatch):
    """Install the given JAX draws as the port's noise; on teardown, all must be used."""
    fed = []

    def install(arrays):
        draws = Draws(arrays)
        monkeypatch.setattr(_noise, "normal", draws)
        fed.append(draws)

    yield install
    assert all(not d.queue for d in fed), "JAX draws left unused"


def _splits(key, n, shape):
    """n normals of ``shape``, one split of ``key`` each (a solver's per-step draws)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, shape))
    return out


def _karras_draws(key, shape, solver_draws):
    """karras_sample's / a Karras stage's draws: x_T, then the solver's from the rest."""
    key, init_key = jax.random.split(key)
    return [jax.random.normal(init_key, shape)] + solver_draws(key)


L, D = 2, 4  # the toy's latent: L tokens of width D
_AB = np.cumprod(1.0 - np.linspace(1e-4, 0.02, 1000)).astype(np.float32)  # linear, 1000


def _toy_weights(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 3), "u": (3, 3), "v": (3,), "p": (D, 3), "q": (3, D),
              "base": (SHAPE[1], 3)}
    return {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for k, shape in shapes.items()}


def _toy(xp, wts):
    """The toy denoiser over array module ``xp`` (jnp or torch): an epsilon model whose
    x_0 prediction is target(cond) - 0.1 sqrt(1 - alpha_bar_t) tanh(x W + mean(latent) P +
    t/1000 v), with target = 0.4 tanh(cond U) + base (cond = 0 in CFG's zeroed rows), and
    latent' = tanh(latent / 2 + mean_points(x) Q). A contraction toward its target, like a
    trained denoiser: its predictions stay inside [-1, 1], where a steeper toy's clipped
    ones make the last steps multiply the two packages' fp32 rounding differences by the
    solver's 1 / sigma (the JAX package differs from itself, jit against eager, by up to
    2e-3 on such a toy)."""
    t_ = torch if xp is torch else None
    w = {k: (torch.from_numpy(v) if t_ else jnp.asarray(v)) for k, v in wts.items()}
    ab_table = torch.from_numpy(_AB) if t_ else jnp.asarray(_AB)

    def model(x, t, cond=None, prev_latent=None, **_):
        lat = xp.zeros((x.shape[0], L, D)) if prev_latent is None else prev_latent
        ab = ab_table[t].reshape(-1, 1, 1)
        tf = (t.float() if t_ else t)[:, None, None] / 1000.0
        target = 0.4 * xp.tanh(cond @ w["u"])[:, None] + w["base"]
        wobble = xp.tanh(x @ w["w"] + lat.mean(1, keepdims=True) @ w["p"] + tf * w["v"])
        eps = ((x / xp.sqrt(ab) - target) / xp.sqrt(1.0 / ab - 1.0)
               + 0.1 * xp.sqrt(ab) * wobble)
        return eps, xp.tanh(0.5 * lat + x.mean(1, keepdims=True) @ w["q"])
    return model


def jax_toy(wts):
    return _toy(jnp, wts)


def torch_toy(wts):
    return _toy(torch, wts)


@pytest.fixture(scope="module")
def toy():
    """The toy on both sides with its CFG kwargs (conditional rows, then zeros) and the
    2B-row initial latent."""
    wts = _toy_weights()
    cond = np.random.default_rng(1).standard_normal((B, 3)).astype(np.float32)
    cfg = np.concatenate([cond, np.zeros_like(cond)])
    lat = np.zeros((2 * B, L, D), np.float32)
    return (jax_toy(wts), torch_toy(wts), {"cond": jnp.asarray(cfg)},
            {"cond": torch.from_numpy(cfg)}, jnp.asarray(lat), torch.from_numpy(lat), cond)


def _toy_denoisers(toy, guided=True):
    jm, tm, jkw, tkw, _, _, _ = toy
    jd, td = jdiffusion("linear", 1000), tdiffusion("linear", 1000)
    jden = jk.gaussian_denoise_fn(jm, jd, model_kwargs=jkw)
    tden = tk.gaussian_denoise_fn(tm, td, model_kwargs=tkw)
    if guided:
        jden, tden = jk.guided_denoise_fn(jden, 3.0), tk.guided_denoise_fn(tden, 3.0)
    return jden, tden


@pytest.fixture(scope="module")
def tiny_bound():
    """The tiny TwoStreamDenoiser (seeded weights) bound with its sampling hooks, and the
    CFG kwargs its hooks build from one conditioning batch."""
    rng = np.random.default_rng(3)
    batch = dict(class_labels=torch.from_numpy(rng.integers(0, 10, (B,))),
                 viewpoints=torch.from_numpy(rng.standard_normal((B, 3)).astype(np.float32)))
    tmod = init_params(TTwoStream(**TINY, device="cpu"), torch.Generator().manual_seed(3))
    bound = TBound(tmod.eval())
    with torch.no_grad():
        kwargs = bound.cfg_model_kwargs(B, batch)
    return bound, kwargs


class _Hooked:
    """A model with an ``init_latent`` hook and no other."""

    def __init__(self, model, zeros):
        self.model, self.zeros = model, zeros

    def __call__(self, *args, **kwargs):
        return self.model(*args, **kwargs)

    def init_latent(self, batch_size):
        return self.zeros((batch_size, L, D))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _close_out(got, want, progressive):
    for key in ("x", "pred_xstart", "state"):
        _close(got[key], want[key], what=key)
    if progressive:
        assert set(got["trajectory"]) == set(want["trajectory"])
        sigmas = np.asarray(want["trajectory"]["sigma"])
        for key, value in want["trajectory"].items():
            _close_steps(got["trajectory"][key], value, sigmas, what=f"trajectory {key}")


def _close_steps(got, want, sigmas, what=""):
    """A trajectory, step by step, within TOL of each value and of the step's sigma (at
    least 1): at sigma = 170 (120 churned) x and the terms whose difference is the x_0
    prediction are of that size, so an fp32 rounding there is an absolute error of
    ~1e-6 sigma (times CFG's 5) in both, and the solver carries it down as an absolute
    one."""
    got, want = got.detach().numpy(), np.asarray(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(sigmas[i]))
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale, err_msg=f"{what} {i}")


def _x_T(seed, scale=120.0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32) * scale


# The churned and ancestral runs end their grid at sigma 0.1, not 1e-3: Heun's corrector
# divides by the next sigma, so on a 4-step grid ending at 1e-3 the step into it turns the
# last bits of an x_0 prediction into 1e-3 of x, and the JAX package's own progressive
# trajectory differs from itself (jit against eager) by 9.7e-4 there; ending at 0.1 it
# differs by 2.6e-5.
SIGMA_MIN = 0.1

# Churn in an interval (the first and last steps, at 120 and 0.1, lie outside it: no draw
# there; fed the JAX draws of the others) and churn with s_noise = 0 (deterministic:
# nothing fed, the port's own draws scaled by 0).
CHURN = {"interval": dict(s_churn=3.0, s_tmin=0.5, s_tmax=50.0),
         "no noise": dict(s_churn=3.0, s_noise=0.0)}


@pytest.mark.parametrize("churn", list(CHURN))
@pytest.mark.parametrize("solver", ["heun", "dpm"])
def test_churned_solvers(toy, feed, solver, churn):
    """One JAX run, progressive; the port's runs with and without ``progressive`` against
    it (the JAX package's final values do not depend on the flag)."""
    jlat, tlat = toy[4], toy[5]
    jden, tden = _toy_denoisers(toy)
    sigmas = jk.get_sigmas_karras(STEPS, SIGMA_MIN, 120.0)
    kw = CHURN[churn]
    x_T = _x_T(9)
    key = jax.random.PRNGKey(21)
    jfn, tfn = ((jk.sample_heun, tk.sample_heun) if solver == "heun"
                else (jk.sample_dpm, tk.sample_dpm))
    want = jfn(jden, jnp.asarray(x_T), sigmas, key, state=jlat, progressive=True, **kw)
    fed = kw.get("s_noise", 1.0) != 0.0
    if fed:
        lo, hi = kw["s_tmin"], kw["s_tmax"]
        churned = [lo <= s <= hi for s in sigmas[:-1].astype(np.float32)]
        assert 0 < sum(churned) < STEPS
        draws = [d for d, c in zip(_splits(key, STEPS, SHAPE), churned) if c]
    for progressive in (False, True):
        if fed:
            feed(draws)
        got = tfn(tden, torch.from_numpy(x_T), sigmas, state=tlat, progressive=progressive,
                  generator=torch.Generator().manual_seed(0), **kw)
        _close_out(got, want, progressive)


def test_euler_ancestral(toy, feed):
    jlat, tlat = toy[4], toy[5]
    jden, tden = _toy_denoisers(toy)
    sigmas = jk.get_sigmas_karras(STEPS, SIGMA_MIN, 120.0)
    x_T = _x_T(10)
    key = jax.random.PRNGKey(22)
    want = jk.sample_euler_ancestral(jden, jnp.asarray(x_T), sigmas, key, state=jlat,
                                     progressive=True)
    for progressive in (False, True):
        feed(_splits(key, STEPS, SHAPE)[:-1])  # the last step's sigma_up is 0
        got = tk.sample_euler_ancestral(tden, torch.from_numpy(x_T), sigmas, state=tlat,
                                        progressive=progressive)
        _close_out(got, want, progressive)


def test_guided_interval_heun_reuse_progressive(toy):
    """Guidance-interval CFG over heun_reuse segments, progressive: the segments'
    trajectories joined, each segment's conditional-only steps on the first B state rows."""
    jm, tm, jkw, tkw, jlat, tlat, _ = toy
    jcfg, tcfg = _toy_denoisers(toy)
    sigmas = jk.get_sigmas_karras(8, 1e-3, 120.0)
    x_T = _x_T(11)
    jd, td = jdiffusion("linear", 1000), tdiffusion("linear", 1000)
    jcond = jk.gaussian_denoise_fn(jm, jd, model_kwargs=jk.half_model_kwargs(jkw, B))
    tcond = tk.gaussian_denoise_fn(tm, td, model_kwargs=tk.half_model_kwargs(tkw, B))
    gi = dict(guidance_interval=(0.1, 10.0), sampler="heun_reuse", cond_batch=B,
              progressive=True)
    assert len(tk.gi_segment_runs(sigmas, gi["guidance_interval"])) == 3
    want = jk.sample_guided_interval(jcond, jcfg, jnp.asarray(x_T), sigmas,
                                     jax.random.PRNGKey(0), state=jlat, **gi)
    got = tk.sample_guided_interval(tcond, tcfg, torch.from_numpy(x_T), sigmas, state=tlat,
                                    **gi)
    assert got["trajectory"]["x"].shape[0] == len(sigmas) - 1
    _close_out(got, want, True)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_heun_parallel(toy, feed, tol):
    """Through karras_sample on both sides (the port folds the window into the batch,
    the JAX package vmaps it), CFG and the latent carried; at tol 0 also against the
    sequential heun from the same x_T."""
    jm, tm, jkw, tkw, jlat, tlat, _ = toy
    steps, window = 10, 4
    jd, td = jdiffusion("linear", 1000), tdiffusion("linear", 1000)
    key = jax.random.PRNGKey(5)
    common = dict(guidance_scale=3.0, sigma_min=1e-3, sigma_max=120.0)
    opts = dict(window=window, tol=tol)
    want = jk.karras_sample(jd, jm, SHAPE, steps, key, model_kwargs=jkw, init_state=jlat,
                            sampler="heun_parallel", parallel_options=opts, **common)
    feed(_karras_draws(key, SHAPE, lambda k: []))
    got = tk.karras_sample(td, tm, SHAPE, steps, None, model_kwargs=tkw, init_state=tlat,
                           sampler="heun_parallel", parallel_options=opts, device="cpu",
                           **common)
    assert got["parallel_iters"] == int(want["parallel_iters"]) <= steps
    _close_out(got, want, False)
    if tol == 0.0:
        feed(_karras_draws(key, SHAPE, lambda k: []))
        seq = tk.karras_sample(td, tm, SHAPE, steps, None, model_kwargs=tkw, init_state=tlat,
                               sampler="heun", device="cpu", **common)
        _close_out(got, seq, False)


def test_heun_parallel_folds_the_flagship_hooks(tiny_bound):
    """The tiny TwoStreamDenoiser through its hooks (cached conditioning tokens tiled
    across the window, the 2B-row latent laid out by CFG group): heun_parallel at tol 0
    equals the sequential heun, with two calls of W x 2B rows an iteration. The grid ends
    at SIGMA_MIN: the window's products over 4x the rows round their last bits
    differently from the sequential ones', which a grid ending at 1e-3 turns into 1e-3."""
    tbound, tkw = tiny_bound
    td = tdiffusion("linear", 1000)
    x_T = torch.from_numpy(_x_T(12))
    sigmas = tk.get_sigmas_karras(6, SIGMA_MIN, 120.0)
    seen = []
    hook = tbound.module.register_forward_pre_hook(lambda m, args: seen.append(len(args[0])))
    try:
        with torch.no_grad():
            seq = tk.sample_heun(_guided(tbound, td, tkw), x_T, sigmas,
                                 state=tbound.init_latent(2 * B))
            seen.clear()
            par = sample_heun_parallel(_guided(tbound, td, window_model_kwargs(tkw, B, 4, 2)),
                                       x_T, sigmas, state=tbound.init_latent(2 * B), window=4,
                                       tol=0.0, groups=2)
    finally:
        hook.remove()
    assert seen == [4 * 2 * B] * (2 * par["parallel_iters"])
    _close_out(par, seq, False)


def _guided(bound, diffusion, kwargs):
    return tk.guided_denoise_fn(tk.gaussian_denoise_fn(bound, diffusion, model_kwargs=kwargs),
                                3.0)


def test_heun_parallel_refuses_what_it_lacks():
    x = torch.zeros(SHAPE)
    sigmas = tk.get_sigmas_karras(4, 1e-3, 10.0)
    for kw in (dict(s_churn=1.0), dict(window_spec="data")):
        with pytest.raises(NotImplementedError):
            sample_heun_parallel(lambda x, s, st: (x, st), x, sigmas, **kw)


@pytest.mark.parametrize("entry", ["karras_sample", "p_sample_loop", "ddim_sample_loop"])
def test_loops_default_to_the_card(monkeypatch, entry):
    """With no generator and no device a loop draws x_T on the card, as every entry point
    of the port defaults to it: with no card present that raises, and the CPU is used
    only when asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td = tdiffusion("linear", 1000, respacing="8")
    model = lambda x, t, **_: torch.zeros_like(x)  # noqa: E731
    if entry == "karras_sample":
        call = lambda **kw: tk.karras_sample(td, model, SHAPE, STEPS, None, **kw)  # noqa: E731
    else:
        call = lambda **kw: getattr(td, entry)(model, SHAPE, None, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    x = out["x"] if entry == "karras_sample" else out
    assert x.device.type == "cpu" and x.shape == SHAPE


def test_karras_sample_edm_denoiser(feed):
    """karras_sample's KarrasDenoiser branch, unguided and stateless, churned heun."""
    w = np.random.default_rng(12).standard_normal((3, 3)).astype(np.float32) * 0.5
    wt = torch.from_numpy(w)
    jm = lambda x, t, **_: jnp.tanh(x @ w + 0.001 * t[:, None, None])  # noqa: E731
    tm = lambda x, t, **_: torch.tanh(x @ wt + 0.001 * t[:, None, None])  # noqa: E731
    key = jax.random.PRNGKey(6)
    kw = dict(sampler="heun", s_churn=1.0, sigma_max=20.0, progressive=True)
    want = jk.karras_sample(jk.KarrasDenoiser(), jm, SHAPE, STEPS, key, **kw)
    feed(_karras_draws(key, SHAPE, lambda k: _splits(k, STEPS, SHAPE)))
    got = tk.karras_sample(tk.KarrasDenoiser(), tm, SHAPE, STEPS, None, device="cpu", **kw)
    for k in ("x", "pred_xstart"):
        _close(got[k], want[k], what=k)
    _close_steps(got["trajectory"]["x"], want["trajectory"]["x"],
                 np.asarray(want["trajectory"]["sigma"]))


def _pc_sampler(mod, model, diffusion, **over):
    cfg = dict(models=[model], diffusions=[diffusion], num_points=[TINY["num_points"]],
               aux_channels=[], guidance_scale=[3.0], clip_denoised=True, use_karras=[True],
               karras_steps=[STEPS], sigma_min=[1e-3], sigma_max=[120.0], s_churn=[0.0])
    cfg.update(over)
    return mod.PointCloudSampler(**cfg)


def test_ddpm_stage(toy, feed):
    """use_karras false: the DDPM chain with the fused-CFG epsilon (CFG kwargs by the
    default zero-doubling) and the latent carry, through sample_batch on both sides."""
    jtoy, ttoy, _, _, _, _, cond = toy
    calls = []
    jm, tm = _Hooked(jtoy, jnp.zeros), _Hooked(ttoy, torch.zeros)
    tm.model = lambda *a, **k: calls.append(1) or ttoy(*a, **k)
    steps = 25
    jd, td = jdiffusion("linear", steps), tdiffusion("linear", steps)
    key = jax.random.PRNGKey(8)
    want = _pc_sampler(jsampler, jm, jd, use_karras=[False]).sample_batch(
        B, {"cond": jnp.asarray(cond)}, key)
    _, sub = jax.random.split(key)
    sub, init_key = jax.random.split(sub)
    feed([jax.random.normal(init_key, SHAPE)] + _splits(sub, steps, SHAPE))
    got = _pc_sampler(tsampler, tm, td, use_karras=[False]).sample_batch(
        B, {"cond": torch.from_numpy(cond)}, torch.Generator())
    _close(got, want)
    assert len(calls) == steps


def test_respaced_ddpm_stage_maps_timesteps(feed):
    """A respaced process's model sees the base process's timesteps, as under the JAX
    package's p_sample_loop (its PointCloudSampler's ancestral stage passes the spaced
    indices through unmapped)."""
    w = np.random.default_rng(13).standard_normal((3, 3)).astype(np.float32) * 0.5
    wt = torch.from_numpy(w)
    seen = []

    def jm(x, t, **_):
        return jnp.tanh(x @ w + (t[:, None, None] / 100.0))

    def tm(x, t, prev_latent=None, **_):
        seen.append(int(t[0]))
        return torch.tanh(x @ wt + (t[:, None, None].float() / 100.0))

    jd, td = jdiffusion("linear", 100, respacing="10"), tdiffusion("linear", 100,
                                                                   respacing="10")
    key = jax.random.PRNGKey(9)
    want = jd.p_sample_loop(jm, SHAPE, key, clip_denoised=True, progressive=True)
    key2, init_key = jax.random.split(key)
    feed([jax.random.normal(init_key, SHAPE)] + _splits(key2, 10, SHAPE))
    ts = _pc_sampler(tsampler, tm, td, use_karras=[False], guidance_scale=[0.0])
    got = ts.sample_batch(B, {}, torch.Generator())
    _close(got, want["pred_xstart"][-1])
    assert seen == sorted(td.timestep_map, reverse=True)


def test_two_stage_sampler(toy, feed):
    """A base stage (the toy with only the latent hook, so CFG by the default zero-doubling,
    and churned
    heun: the JAX package's default s_churn (3, 0)) then a duck-typed low_res stage, both
    with the same numpy weights on both sides, the second unguided (a single guidance scale
    guides the base stage only) with its kwargs filtered out."""
    jtoy, ttoy, _, _, _, _, cond = toy
    jm, tm = _Hooked(jtoy, jnp.zeros), _Hooked(ttoy, torch.zeros)
    w = np.random.default_rng(14).standard_normal((6, 3)).astype(np.float32) * 0.5
    wt = torch.from_numpy(w)

    def jup(x, t, low_res=None, **kw):
        assert not kw
        ctx = jnp.broadcast_to(low_res.mean(axis=1, keepdims=True), x.shape)
        return jnp.tanh(jnp.concatenate([x, ctx], -1) @ w + t[:, None, None] / 1000.0)

    def tup(x, t, low_res=None, **kw):
        assert not kw
        ctx = low_res.mean(dim=1, keepdim=True).expand_as(x)
        return torch.tanh(torch.cat([x, ctx], -1) @ wt + t[:, None, None].float() / 1000.0)

    over = dict(num_points=[TINY["num_points"], 8], guidance_scale=[3.0],
                karras_steps=[STEPS, 3], sigma_min=[1e-3], sigma_max=[120.0, 40.0],
                model_kwargs_key_filter=["*", ""])
    js = jsampler.PointCloudSampler(models=[jm, jup],
                                    diffusions=[jdiffusion("linear", 1000)] * 2, **over)
    ts = tsampler.PointCloudSampler(models=[tm, tup],
                                    diffusions=[tdiffusion("linear", 1000)] * 2, **over)
    assert ts.guidance_scale == [3.0, 1.0] and ts.s_churn == [3, 0]
    key = jax.random.PRNGKey(10)
    want = list(js.sample_batch_progressive(B, {"cond": jnp.asarray(cond)}, key))
    draws, k = [], key
    for stage, (n, shape) in enumerate(((STEPS, SHAPE), (3, (B, 8, 3)))):
        k, sub = jax.random.split(k)
        sub, init_key = jax.random.split(sub)
        draws.append(jax.random.normal(init_key, shape))
        if stage == 0:
            draws += _splits(sub, n, shape)  # churned at every step
    feed(draws)
    got = list(ts.sample_batch_progressive(B, {"cond": torch.from_numpy(cond)},
                                           torch.Generator()))
    assert [tuple(g.shape) for g in got] == [SHAPE, (B, 24, 3)]
    for g, wnt in zip(got, want):
        _close(g, wnt)
    assert torch.equal(got[1][:, :16], got[0])


def test_conversions():
    kw = dict(models=[None, None], diffusions=[tdiffusion("linear", 50)] * 2,
              num_points=[4, 4], aux_channels=["R", "G", "B"], guidance_scale=[3.0])
    jkw = dict(kw, diffusions=[jdiffusion("linear", 50)] * 2)
    ts, js = tsampler.PointCloudSampler(**kw), jsampler.PointCloudSampler(**jkw)
    out = np.random.default_rng(15).uniform(-20, 280, (2, 8, 6)).astype(np.float32)
    for rescale in (False, True):
        tpos, taux = ts.split_model_output(torch.from_numpy(out), rescale)
        jpos, jaux = js.split_model_output(jnp.asarray(out), rescale)
        _close(tpos, jpos, 1e-5)
        assert taux.keys() == jaux.keys()
        for k in jaux:
            _close(taux[k], jaux[k], 1e-5, k)
    for tpc, jpc in zip(ts.output_to_point_clouds(torch.from_numpy(out)),
                        js.output_to_point_clouds(jnp.asarray(out))):
        _close(tpc.coords, jpc.coords, 1e-5)
        for k in "RGB":
            _close(tpc.channels[k], jpc.channels[k], 1e-5, k)
    both = tsampler.PointCloudSampler.combine(ts, ts.with_options([2.0, 1.0], True))
    jboth = jsampler.PointCloudSampler.combine(js, js.with_options([2.0, 1.0], True))
    for attr in ("num_points", "guidance_scale", "use_karras", "karras_steps", "sigma_min",
                 "sigma_max", "s_churn", "model_kwargs_key_filter"):
        assert getattr(both, attr) == getattr(jboth, attr), attr
    assert both.num_stages == 4 and both.clip_denoised
    with pytest.raises(ValueError):
        tsampler.PointCloudSampler(models=[None], diffusions=[None], num_points=[4])
