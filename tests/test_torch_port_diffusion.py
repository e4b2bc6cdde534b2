"""The port's diffusion processes against the JAX package's, on the CPU in fp32.

- Schedules, respacing and every coefficient table: equal (both are float64 numpy).
- The KL and likelihood helpers, and one step of each process function, on the same
  numpy inputs through a toy model with numpy weights (the same function on both sides):
  within 1e-5 (fp32 arithmetic in another order).
- The mean x variance x loss grid: ``p_mean_variance``, every term of
  ``training_losses`` (with the chamfer term) and the gradient of the summed loss with
  respect to the toy model's weights, which holds the learned variance's bound on a
  detached mean: within 1e-5, gradients within 1e-5 of their largest entry.
- Loops (ancestral, DDIM, the bound over the chain), fed the JAX package's own normals in
  its key-split order through the port's one noise seam: within 1e-4.
- ``SpacedDiffusion``, ``diffusion_from_config`` (the Point-E presets, six channels with
  their scales) and ``KarrasDenoiser``.
- The learned-variance train step (``learned_range``, ``rescaled_mse``, six output
  channels) on a tiny denoiser: loss and terms within 1e-5, every gradient within the
  train step's own parity limits (tests/test_torch_port_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.diffusion import configs as jconfigs
from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.diffusion import gaussian as jg
from pcdiff.diffusion import karras as jk
from pcdiff.diffusion import schedules as js
from pcdiff.models import attention as jattn
from pcdiff.models.embeddings import fourier_pe as jfourier
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.data import synthetic_batch
from pcdiff_torch.diffusion import _noise
from pcdiff_torch.diffusion import configs as tconfigs
from pcdiff_torch.diffusion import diffusion_from_betas as tdiffusion
from pcdiff_torch.diffusion import gaussian as tg
from pcdiff_torch.diffusion import karras as tk
from pcdiff_torch.diffusion import schedules as ts
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.embeddings import fourier_pe as tfourier
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.train import make_loss_fn

torch.set_num_threads(2)

STEP_TOL = 1e-5
LOOP_TOL = 1e-4
T = 50
B, N, C = 3, 5, 3
TS = np.array([0, 17, T - 1], dtype=np.int32)
MEANS = ("epsilon", "x_start", "x_prev")
VARS = ("fixed_small", "fixed_large", "learned", "learned_range")
LOSSES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


def _close(got, want, tol=STEP_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _toy(c_in, c_out, seed=0):
    """The same small function on both sides: tanh(x W + b + (t / T) u), numpy weights."""
    rng = np.random.default_rng(seed)
    w = (0.5 * rng.standard_normal((c_in, c_out))).astype(np.float32)
    b = (0.2 * rng.standard_normal(c_out)).astype(np.float32)
    u = (0.5 * rng.standard_normal(c_out)).astype(np.float32)

    def jmodel(weight):
        return lambda x, t, **_: jnp.tanh(x @ weight + b + (t[:, None, None] / T) * u)

    def tmodel(weight):
        bt, ut = torch.from_numpy(b), torch.from_numpy(u)
        return lambda x, t, **_: torch.tanh(x @ weight + bt + (t[:, None, None].float() / T)
                                            * ut)

    return w, jmodel, tmodel


def _inputs(seed=1, c=C):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((B, N, c)), -1, 1).astype(np.float32)
    noise = rng.standard_normal((B, N, c)).astype(np.float32)
    return x, noise


class Draws:
    """A stand-in for the port's noise seam that hands out given arrays in order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, shape, generator, device, dtype=torch.float32):
        a = self.queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a).to(device=device, dtype=dtype)


def _loop_draws(key, shape, steps):
    """The JAX loops' normals: x_T from the first split, then one a step."""
    key, init_key = jax.random.split(key)
    draws = [jax.random.normal(init_key, shape)]
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, shape))
    return draws


# ---------------------------------------------------------------- schedules, tables

@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 64), ("cosine", 1024),
                                        ("cosine", 50)])
def test_named_schedules_equal(name, steps):
    np.testing.assert_array_equal(ts.get_named_beta_schedule(name, steps),
                                  js.get_named_beta_schedule(name, steps))


@pytest.mark.parametrize("counts", ["10", "5,3", [4, 2, 1], "ddim25", "exact0,7,49", "50"])
def test_space_timesteps_equal(counts):
    assert ts.space_timesteps(T, counts) == js.space_timesteps(T, counts)


def test_betas_for_alpha_bar_and_bad_requests():
    fn = lambda t: 1.0 - t ** 2  # noqa: E731
    np.testing.assert_array_equal(ts.betas_for_alpha_bar(16, fn, 0.5),
                                  js.betas_for_alpha_bar(16, fn, 0.5))
    for bad in ("ddim11", "exact50", "60"):
        with pytest.raises(ValueError):
            ts.space_timesteps(T, bad)
    with pytest.raises(NotImplementedError):
        ts.get_named_beta_schedule("sqrt", 10)


def test_tables_equal():
    jd, td = jdiffusion("cosine", T), tdiffusion("cosine", T)
    for name, value in vars(jd).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(td, name), value, err_msg=name)
    t = torch.from_numpy(TS).long()
    _close(td.get_sigmas(t), jd.get_sigmas(jnp.asarray(TS)))
    x, noise = _inputs()
    for got, want in zip(td.q_mean_variance(torch.from_numpy(x), t),
                         jd.q_mean_variance(jnp.asarray(x), jnp.asarray(TS))):
        _close(got, want)
    _close(td.q_sample(torch.from_numpy(x), t, torch.from_numpy(noise)),
           jd.q_sample(jnp.asarray(x), jnp.asarray(TS), jnp.asarray(noise)))


def test_kl_and_likelihood_helpers():
    rng = np.random.default_rng(5)
    a, b, c, d = (rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(4))
    _close(tg.normal_kl(*map(torch.from_numpy, (a, b, c, d))), jg.normal_kl(a, b, c, d))
    _close(tg.normal_kl(torch.from_numpy(a), torch.from_numpy(b), 0.0, 0.0),
           jg.normal_kl(a, b, 0.0, 0.0))
    _close(tg.approx_standard_normal_cdf(torch.from_numpy(a)),
           jg.approx_standard_normal_cdf(jnp.asarray(a)))
    x = np.concatenate([np.full((1, N, C), -1.0), np.full((1, N, C), 1.0),
                        np.clip(a[:1], -0.9, 0.9)]).astype(np.float32)
    want = np.asarray(jg.discretized_gaussian_log_likelihood(jnp.asarray(x), means=c,
                                                             log_scales=0.1 * d))
    got = tg.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(c), log_scales=torch.from_numpy(0.1 * d))
    np.testing.assert_array_less(np.abs(got.numpy() - want), _likelihood_tol(want))


def _likelihood_tol(loglik):
    """The discretised likelihood's limit: 1e-5, plus four fp32 ulps of a CDF near 1 (the
    two packages' tanh differ by ulps) over the bin mass exp(loglik) that the difference
    of two such CDFs leaves (a tail bin of mass 1e-4 turns one ulp, 6e-8, into 6e-4 of
    its log: measured 3.2e-4 at such a bin, where JAX and the port miss the float64
    value by 9e-5 and 2.3e-4)."""
    return STEP_TOL + 4 * 2.0 ** -24 * np.exp(-np.asarray(loglik, np.float64))


def test_decoder_nll_at_t0():
    """The bound's t = 0 term under ``discretized_t0``, within the likelihood's limit
    averaged as the term averages it."""
    kw = dict(model_var_type="learned_range", loss_type="kl", discretized_t0=True)
    jd, td = jdiffusion("linear", T, **kw), tdiffusion("linear", T, **kw)
    w, jmodel, tmodel = _toy(C, 2 * C)
    x, noise = _inputs()
    t = np.zeros(B, np.int32)
    jx_t = jd.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    want = jd._vb_terms_bpd(jmodel(w), jnp.asarray(x), jx_t, jnp.asarray(t))["output"]
    got = td._vb_terms_bpd(tmodel(torch.from_numpy(w)), torch.from_numpy(x),
                           torch.from_numpy(np.asarray(jx_t)), torch.from_numpy(t).long())
    out = jd.p_mean_variance(jmodel(w), jx_t, jnp.asarray(t))
    ll = jg.discretized_gaussian_log_likelihood(jnp.asarray(x), means=out["mean"],
                                                log_scales=0.5 * out["log_variance"])
    tol = _likelihood_tol(ll).reshape(B, -1).mean(axis=1) / np.log(2.0)
    np.testing.assert_array_less(np.abs(got["output"].numpy() - np.asarray(want)), tol)


def test_fourier_pe():
    xyz = np.random.default_rng(6).uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    _close(tfourier(torch.from_numpy(xyz), 6, 0.7), jfourier(jnp.asarray(xyz), 6, 0.7))


# ------------------------------------------------------------- the type grid

@pytest.mark.parametrize("loss_type", LOSSES)
@pytest.mark.parametrize("var_type", VARS)
@pytest.mark.parametrize("mean_type", MEANS)
def test_mean_variance_loss_grid(mean_type, var_type, loss_type):
    # the t = 0 term's discretised likelihood has its own limit (test_decoder_nll_at_t0)
    kw = dict(model_mean_type=mean_type, model_var_type=var_type, loss_type=loss_type)
    jd, td = jdiffusion("linear", T, **kw), tdiffusion("linear", T, **kw)
    c_out = 2 * C if var_type.startswith("learned") else C
    w, jmodel, tmodel = _toy(C, c_out)
    x, noise = _inputs()
    jt, tt = jnp.asarray(TS), torch.from_numpy(TS).long()
    wt = torch.tensor(w, requires_grad=True)

    jout = jd.p_mean_variance(jmodel(w), jnp.asarray(x), jt, clip_denoised=True)
    tout = td.p_mean_variance(tmodel(wt), torch.from_numpy(x), tt, clip_denoised=True)
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        _close(tout[key], jout[key], what=key)

    def jloss(weight):
        terms = jd.training_losses(jmodel(weight), jnp.asarray(x), jt, jnp.asarray(noise),
                                   use_cd_xyz_loss=True)
        return terms["loss"].sum(), terms

    (_, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    tterms = td.training_losses(tmodel(wt), torch.from_numpy(x), tt, torch.from_numpy(noise),
                                use_cd_xyz_loss=True)
    tterms["loss"].sum().backward()
    assert set(tterms) == set(jterms)
    for key, value in jterms.items():
        _close(tterms[key], value, what=key)
    scale = float(np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad), rtol=STEP_TOL,
                               atol=STEP_TOL * scale)


def test_bad_types_raise():
    for kw in (dict(model_mean_type="v"), dict(model_var_type="free"), dict(loss_type="l1")):
        with pytest.raises(ValueError):
            tdiffusion("linear", T, **kw)
    td = tdiffusion("linear", T, model_var_type="learned")
    with pytest.raises(ValueError):  # a learned variance needs 2C output channels
        td.p_mean_variance(lambda x, t: x, torch.zeros(B, N, C), torch.zeros(B).long())


# ---------------------------------------------------------------- single steps

def test_p_sample_ddim_and_conditioning_steps(monkeypatch):
    jd, td = jdiffusion("linear", T), tdiffusion("linear", T)
    w, jmodel, tmodel = _toy(C, C)
    x, _ = _inputs()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jt, tt = jnp.asarray(TS), torch.from_numpy(TS).long()
    jm, tm = jmodel(w), tmodel(torch.from_numpy(w))
    key = jax.random.PRNGKey(3)
    draw = jax.random.normal(key, x.shape)

    monkeypatch.setattr(_noise, "normal", Draws([draw]))
    _close(td.p_sample(tm, tx, tt, None, clip_denoised=True)["sample"],
           jd.p_sample(jm, jx, jt, key, clip_denoised=True)["sample"])
    for eta in (0.0, 0.5):
        monkeypatch.setattr(_noise, "normal", Draws([draw] if eta else []))
        got = td.ddim_sample(tm, tx, tt, None, clip_denoised=True, eta=eta)
        want = jd.ddim_sample(jm, jx, jt, key, clip_denoised=True, eta=eta)
        for k in ("sample", "pred_xstart"):
            _close(got[k], want[k], what=f"ddim eta {eta} {k}")
    _close(td.ddim_reverse_sample(tm, tx, tt)["sample"],
           jd.ddim_reverse_sample(jm, jx, jt)["sample"])

    cond_j = lambda x, t, **_: 0.1 * jnp.sin(x)  # noqa: E731
    cond_t = lambda x, t, **_: 0.1 * torch.sin(x)  # noqa: E731
    jpm, tpm = jd.p_mean_variance(jm, jx, jt), td.p_mean_variance(tm, tx, tt)
    _close(td.condition_mean(cond_t, tpm, tx, tt), jd.condition_mean(cond_j, jpm, jx, jt))
    got, want = td.condition_score(cond_t, tpm, tx, tt), jd.condition_score(cond_j, jpm, jx, jt)
    for k in ("mean", "pred_xstart"):
        _close(got[k], want[k], what=k)
    monkeypatch.setattr(_noise, "normal", Draws([draw]))
    got = td.p_sample(tm, tx, tt, None, cond_fn=cond_t)["sample"]
    _close(got, jd.p_sample(jm, jx, jt, key, cond_fn=cond_j)["sample"])


# ---------------------------------------------------------------- loops

@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_sampling_loops(monkeypatch, loop, progressive):
    steps = 25
    jd, td = jdiffusion("linear", steps), tdiffusion("linear", steps)
    w, jmodel, tmodel = _toy(C, C)
    key = jax.random.PRNGKey(11)
    kw = dict(clip_denoised=True, progressive=progressive)
    if loop == "ddim_sample_loop":
        kw["eta"] = 0.5
    want = getattr(jd, loop)(jmodel(w), (B, N, C), key, **kw)
    monkeypatch.setattr(_noise, "normal", Draws(_loop_draws(key, (B, N, C), steps)))
    got = getattr(td, loop)(tmodel(torch.from_numpy(w)), (B, N, C), None, device="cpu",
                            **kw)
    if progressive:
        for k in ("sample", "pred_xstart"):
            assert got[k].shape == (steps, B, N, C)
            _close(got[k], want[k], LOOP_TOL, k)
    else:
        _close(got, want, LOOP_TOL)


def test_calc_bpd_loop(monkeypatch):
    steps = 25
    kw = dict(model_var_type="learned_range", discretized_t0=True)
    jd, td = jdiffusion("linear", steps, **kw), tdiffusion("linear", steps, **kw)
    w, jmodel, tmodel = _toy(C, 2 * C)
    x, _ = _inputs()
    key = jax.random.PRNGKey(13)
    want = jd.calc_bpd_loop(jmodel(w), jnp.asarray(x), key)
    draws, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        draws.append(jax.random.normal(sub, x.shape))
    monkeypatch.setattr(_noise, "normal", Draws(draws))
    got = td.calc_bpd_loop(tmodel(torch.from_numpy(w)), torch.from_numpy(x), None)
    assert set(got) == set(want)
    for name, value in want.items():
        _close(got[name], value, LOOP_TOL, name)


# ------------------------------------------------- respacing, presets, EDM scalings

def test_spaced_diffusion(monkeypatch):
    kw = dict(respacing="ddim10", model_var_type="learned_range", loss_type="rescaled_mse")
    jd, td = jdiffusion("linear", 100, **kw), tdiffusion("linear", 100, **kw)
    assert isinstance(td, tg.SpacedDiffusion) and td.num_timesteps == 10
    assert td.timestep_map == jd.timestep_map
    np.testing.assert_array_equal(td.betas, jd.betas)
    seen = []
    w, jmodel, tmodel = _toy(C, 2 * C)

    def spy(weight):
        inner = tmodel(weight)

        def f(x, t, **k):
            seen.append(t.tolist())
            return inner(x, t, **k)
        return f

    x, noise = _inputs()
    t = np.array([0, 4, 9], np.int32)
    tout = td.p_mean_variance(spy(torch.from_numpy(w)), torch.from_numpy(x),
                              torch.from_numpy(t).long())
    jout = jd.p_mean_variance(jmodel(w), jnp.asarray(x), jnp.asarray(t))
    assert seen == [[jd.timestep_map[i] for i in t]]
    for k in ("mean", "log_variance", "pred_xstart"):
        _close(tout[k], jout[k], what=k)
    tterms = td.training_losses(tmodel(torch.from_numpy(w)), torch.from_numpy(x),
                                torch.from_numpy(t).long(), torch.from_numpy(noise))
    jterms = jd.training_losses(jmodel(w), jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    for k in ("mse", "vb", "loss"):
        _close(tterms[k], jterms[k], what=k)


@pytest.mark.parametrize("preset", ["base40M", "upsample", "respaced"])
def test_diffusion_from_config(preset):
    conf = (dict(tconfigs.DIFFUSION_CONFIGS["base40M"], respacing="ddim32")
            if preset == "respaced" else tconfigs.DIFFUSION_CONFIGS[preset])
    assert tconfigs.DIFFUSION_CONFIGS.keys() == jconfigs.DIFFUSION_CONFIGS.keys()
    td, jd = tconfigs.diffusion_from_config(conf), jconfigs.diffusion_from_config(conf)
    assert type(td).__name__ == type(jd).__name__
    assert (td.model_var_type, td.loss_type) == ("learned_range", "mse")
    np.testing.assert_array_equal(td.betas, jd.betas)
    np.testing.assert_array_equal(td.channel_scales, jd.channel_scales)
    # XYZ + RGB (0..255) through the channel scales, a 12-channel output, both chamfers
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.uniform(-0.5, 0.5, (B, N, 3)), rng.uniform(0, 255, (B, N, 3))],
                       axis=-1).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    w, jmodel, tmodel = _toy(6, 12)
    t = np.array([0, 5, td.num_timesteps - 1], np.int32)
    jterms = jd.training_losses(jmodel(w), jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise),
                                use_cd_xyz_loss=True, use_cd_color_loss=True)
    tterms = td.training_losses(tmodel(torch.from_numpy(w)), torch.from_numpy(x),
                                torch.from_numpy(t).long(), torch.from_numpy(noise),
                                use_cd_xyz_loss=True, use_cd_color_loss=True)
    assert set(tterms) == set(jterms) >= {"c_dist", "c_dist_color", "vb"}
    for k, v in jterms.items():
        _close(tterms[k], v, what=k)
    scaled = jd.scale_channels(jnp.asarray(x))
    out = {"a": scaled, "b": 3}
    got = td.unscale_out_dict({"a": torch.from_numpy(np.asarray(scaled)), "b": 3})
    _close(got["a"], jd.unscale_out_dict(out)["a"], what="unscale")
    assert got["b"] == 3


def test_karras_denoiser():
    jkd, tkd = jk.KarrasDenoiser(0.5), tk.KarrasDenoiser(0.5)
    sig = np.array([0.01, 1.0, 80.0], np.float32)
    for got, want in zip(tkd.get_scalings(torch.from_numpy(sig)),
                         jkd.get_scalings(jnp.asarray(sig))):
        _close(got, want)
    w, jmodel, _ = _toy(C, C)
    wt = torch.from_numpy(w)
    # the model sees the EDM time 250 log(sigma): scale it as the toy's t / T expects
    jm = lambda x, t, **_: jnp.tanh(x @ w + 0.001 * t[:, None, None])  # noqa: E731
    tm = lambda x, t, **_: torch.tanh(x @ wt + 0.001 * t[:, None, None])  # noqa: E731
    x, noise = _inputs()
    for got, want in zip(tkd.denoise(tm, torch.from_numpy(x), torch.from_numpy(sig)),
                         jkd.denoise(jm, jnp.asarray(x), jnp.asarray(sig))):
        _close(got, want)
    tterms = tkd.training_losses(tm, torch.from_numpy(x), torch.from_numpy(sig),
                                 torch.from_numpy(noise))
    jterms = jkd.training_losses(jm, jnp.asarray(x), jnp.asarray(sig), jnp.asarray(noise))
    for k, v in jterms.items():
        _close(tterms[k], v, what=k)
    for sf, st in ((np.float32(5.0), np.float32(2.0)), (np.float32(0.3), np.float32(0.0))):
        for got, want in zip(tk.get_ancestral_step(sf, st), jk.get_ancestral_step(sf, st)):
            _close(np.float32(got), want)


# ----------------------------------------------------- the learned-variance train step

TINY = dict(num_points=32, num_latents=8, latent_dim=32, x_dim=32, num_blocks=1,
            num_compute_layers=1, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16, output_channels=6,
            active_modalities=("class", "view"))
_COND = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")


def _params(jmod, rng, *args):
    """A random parameter tree of ``jmod``'s shapes, every path live."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"]
    flat = {}
    for path, sd in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        flat[path] = {"kernel": z / np.sqrt(np.prod(sd.shape[:-1])), "scale": 1 + 0.1 * z,
                      "bias": 0.1 * z}.get(path[-1], 0.3 * z)
    return traverse_util.unflatten_dict(flat)


def test_learned_variance_train_step_matches_jax():
    """make_loss_fn's composition (chamfer on, dropout off; the bootstrap and the heavy
    encoders, which a learned variance does not touch, are held by
    tests/test_torch_port_train.py) with a learned_range variance under rescaled_mse and
    six output channels."""
    jattn.set_ln_dense_fusion("on")
    try:
        rng = np.random.default_rng(4)
        batch = synthetic_batch(rng, 2, 32, 4, 32)
        jmod = JTwoStream(**TINY, cond_drop_prob=0.0)
        params = _params(jmod, rng, batch["target"], np.zeros(2, np.int32),
                         *(batch[k] for k in _COND))
        kw = dict(model_var_type="learned_range", loss_type="rescaled_mse")
        jd = jdiffusion("linear", 1000, **kw)
        t = np.array([3, 700], np.int32)
        noise = rng.standard_normal(batch["target"].shape).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jloss(p):
            v = {"params": p}
            raw = jmod.apply(v, 2, train=False, method="encode_modalities",
                             **{k: jb[k] for k in _COND})
            prev = jnp.zeros((2, jmod.latent_tokens, jmod.latent_dim), jnp.float32)

            def model_fn(x, tt):
                cond_m = jmod.apply(v, raw, 2, train=True, method="assemble_conditioning")
                return jmod.apply(v, x, tt, train=True, cond_tokens=cond_m, prev_latent=prev)

            terms = jd.training_losses(model_fn, jb["target"], jnp.asarray(t),
                                       jnp.asarray(noise), use_cd_xyz_loss=True)
            return terms["loss"].mean(), {k: v.mean() for k, v in terms.items()}

        (want_loss, want_terms), want_grads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(params)
    finally:
        jattn.set_ln_dense_fusion("auto")

    tmod = TTwoStream(**TINY, cond_drop_prob=0.0, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    loss_fn = make_loss_fn(tmod, tdiffusion("linear", 1000, **kw))
    tmod.train()
    for m in tmod.active_modalities:  # encoders deterministic, as on the JAX side
        getattr(tmod, f"encoders_{m}").eval()
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        loss, terms = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.from_numpy(t).long(), torch.from_numpy(noise), False, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_TOL)
    assert {"mse", "vb", "c_dist"} <= set(terms)
    for k in ("mse", "vb", "c_dist"):
        np.testing.assert_allclose(terms[k].item(), float(want_terms[k]), rtol=STEP_TOL,
                                   err_msg=k)
    got = traverse_util.flatten_dict(flax_from_params(
        tmod, {n: p.grad for n, p in tmod.named_parameters()}))
    want = traverse_util.flatten_dict(jax.device_get(want_grads))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():  # the train parity test's limits, for the same reasons
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg="/".join(path))
