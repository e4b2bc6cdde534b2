"""The port's Point-E denoisers, presets, importer and two-stage sampler against the JAX
package's, on the CPU in fp32.

Each model is built from a preset of ``MODEL_CONFIGS`` (and the one class no preset names,
``UpsamplePointDiffusionTransformer``) cut to a tiny width: 2 layers, 2 or 4 heads of 32 or
64. Both packages take one reference ``state_dict``, synthesized from the key patterns of
``pcdiff/core/point_e_import.py`` with every tensor nonzero (so a zero-initialised output
projection hides nothing): the JAX side through its importer, the port through its own and,
again, through ``params_from_flax`` of the JAX tree. The JAX side runs the graph the TPU
runs (``set_ln_dense_fusion("on")``), and the image and text pipelines' presets again in the
fully fused configuration (``set_ln_mlp_fusion("on")`` on both sides), with base300M there at
its full width (1024, 16 heads of 64), one layer, in fp32 and bf16 (bf16 held by
``tests/test_torch_port_bf16.py``'s gap rule). With more than one head, a wrong split of the
interleaved ``c_qkv``, a wrong split scale or a wrong conditioning-token order fails
(``test_wrong_split_scale_or_order_is_seen``). Tolerances: 1e-5 for a model, 1e-4 for the
sampler (fp32 differences carried through the solver's steps, as
tests/test_torch_port_solvers.py), whose stochastic draws are the JAX package's, fed
through the port's noise seam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdiff.core.point_e_import import import_point_e_torch_state as jimport
from pcdiff.diffusion import sampler as jsampler
from pcdiff.diffusion.configs import DIFFUSION_CONFIGS as JDIFF
from pcdiff.diffusion.configs import diffusion_from_config as jdiff_from_config
from pcdiff.models import attention as jattn
from pcdiff.ops import flash_attention as jfa
from pcdiff.models import configs as jconfigs
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.core.point_e_import import import_point_e_torch_state as timport
from pcdiff_torch.diffusion import _noise
from pcdiff_torch.diffusion import sampler as tsampler
from pcdiff_torch.diffusion.configs import DIFFUSION_CONFIGS as TDIFF
from pcdiff_torch.diffusion.configs import diffusion_from_config as tdiff_from_config
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models import configs as tconfigs
from pcdiff_torch.models import point_e as tpe
from pcdiff_torch.ops import flash_attention as tfa
from pcdiff_torch.ops import layer_norm as tln

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

B = 2
N_CTX, COND_CTX, GRID, GRID_DIM, CLIP_DIM = 8, 6, 2, 16, 24
# (preset, width, heads): head dims 32 and 64, more than one head everywhere
CASES = [
    ("base40M-imagevec", 64, 2),
    ("base40M-textvec", 128, 2),
    ("base40M-uncond", 128, 4),
    ("base40M", 128, 2),
    ("base300M", 64, 2),
    ("base1B", 256, 4),
    ("upsample", 128, 2),
    ("UpsamplePointDiffusionTransformer", 64, 2),
]


@pytest.fixture(autouse=True)
def _fused_graph():
    jattn.set_ln_dense_fusion("on")
    yield
    jattn.set_ln_dense_fusion("auto")


def _config(name, width, heads, layers=2):
    """The preset (or, for the class no preset names, the upsample preset under that class)
    cut to the test's size; the same dict builds both packages' modules."""
    if name == "UpsamplePointDiffusionTransformer":  # no grid, so no conditioning dropout
        base = {k: v for k, v in jconfigs.MODEL_CONFIGS["upsample"].items()
                if k != "cond_drop_prob"}
        base["name"] = name
    else:
        base = dict(jconfigs.MODEL_CONFIGS[name])
    over = dict(layers=layers, width=width, heads=heads, n_ctx=N_CTX)
    if "Grid" in base["name"]:
        over.update(grid_size=GRID, grid_feature_dim=GRID_DIM)
    if base["name"] == "CLIPImagePointDiffusionTransformer":
        over.update(clip_feature_dim=CLIP_DIM)
    if "Upsample" in base["name"]:
        over.update(cond_ctx=COND_CTX)
    return {**base, **over}


def _linear(sd, rng, prefix, out_f, in_f):
    sd[f"{prefix}.weight"] = rng.standard_normal((out_f, in_f)).astype(np.float32) / np.sqrt(in_f)
    sd[f"{prefix}.bias"] = (0.1 * rng.standard_normal(out_f)).astype(np.float32)


def _ln(sd, rng, prefix, c):
    sd[f"{prefix}.weight"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{prefix}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)


def _resblock(sd, rng, prefix, w):
    _ln(sd, rng, f"{prefix}.ln_1", w)
    _ln(sd, rng, f"{prefix}.ln_2", w)
    _linear(sd, rng, f"{prefix}.attn.c_qkv", 3 * w, w)
    _linear(sd, rng, f"{prefix}.attn.c_proj", w, w)
    _linear(sd, rng, f"{prefix}.mlp.c_fc", 4 * w, w)
    _linear(sd, rng, f"{prefix}.mlp.c_proj", w, 4 * w)


def reference_state(cfg, seed=0, out_scale=1.0):
    """A reference Point-E ``state_dict`` (numpy) for ``cfg``, in the key patterns the
    importers read; every tensor nonzero, ``output_proj`` times ``out_scale``."""
    rng = np.random.default_rng(seed)
    w, sd = cfg["width"], {}
    _linear(sd, rng, "input_proj", w, cfg["input_channels"])
    _linear(sd, rng, "output_proj", cfg["output_channels"], w)
    sd["output_proj.weight"] *= out_scale
    sd["output_proj.bias"] *= out_scale
    _ln(sd, rng, "ln_pre", w)
    _ln(sd, rng, "ln_post", w)
    _linear(sd, rng, "time_embed.c_fc", 4 * w, w)
    _linear(sd, rng, "time_embed.c_proj", w, 4 * w)
    for i in range(cfg["layers"]):
        _resblock(sd, rng, f"backbone.resblocks.{i}", w)
    name = cfg["name"]
    if name == "CLIPImagePointDiffusionTransformer":
        _linear(sd, rng, "clip_embed", w, cfg["clip_feature_dim"])
    if "Grid" in name:
        _ln(sd, rng, "clip_embed.0", cfg["grid_feature_dim"])
        _linear(sd, rng, "clip_embed.1", w, cfg["grid_feature_dim"])
    if "Upsample" in name:
        _linear(sd, rng, "cond_point_proj", w, cfg["input_channels"])
    return sd


def inputs(cfg, seed=1):
    """(x, t, kwargs) as numpy: fractional timesteps, and the class's conditioning."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg["n_ctx"], cfg["input_channels"])).astype(np.float32)
    t = np.array([3.7, 512.25], np.float32)
    kw, name = {}, cfg["name"]
    if name == "CLIPImagePointDiffusionTransformer":
        kw["embeddings"] = rng.standard_normal((B, cfg["clip_feature_dim"])).astype(np.float32)
    if "Grid" in name:
        kw["embeddings"] = rng.standard_normal(
            (B, GRID ** 2, cfg["grid_feature_dim"])).astype(np.float32)
    if "Upsample" in name:
        lr = rng.standard_normal((B, cfg["cond_ctx"], cfg["input_channels"]))
        kw["low_res"] = (lr * [1, 1, 1, 60, 60, 60][: cfg["input_channels"]] + 1).astype(np.float32)
    return x, t, kw


_JIT = {}


def jax_forward(cfg, variables, x, t, kw):
    key = repr(sorted(cfg.items()))
    if key not in _JIT:
        jmod = jconfigs.model_from_config(cfg)
        _JIT[key] = jax.jit(lambda v, x, t, kw: jmod.apply(v, x, t, **kw))
    return np.asarray(_JIT[key](variables, x, t, {k: jnp.asarray(v) for k, v in kw.items()}))


def port_model(cfg, state, dtype=torch.float32):
    model = tconfigs.model_from_config(cfg, dtype=dtype, device="cpu")
    model.load_state_dict(state, strict=True)
    return model.eval()


def port_forward(model, x, t, kw):
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    return out.float().numpy()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_presets_equal_the_jax_ones():
    assert tconfigs.MODEL_CONFIGS == jconfigs.MODEL_CONFIGS
    for name, cfg in tconfigs.MODEL_CONFIGS.items():
        model = tconfigs.model_from_config(cfg, device="meta")
        assert type(model).__name__ == cfg["name"] == type(
            jconfigs.model_from_config(jconfigs.MODEL_CONFIGS[name])).__name__, name
    with pytest.raises(ValueError):
        tconfigs.model_from_config({"name": "Nope"}, device="meta")


@pytest.mark.parametrize("name,width,heads", CASES, ids=[c[0] for c in CASES])
def test_model_matches_jax(name, width, heads):
    cfg = _config(name, width, heads)
    sd = reference_state(cfg)
    variables = jimport(sd)
    state = timport(sd)
    # the JAX tree carries across to the same state_dict, and back to the same tree
    via_flax = params_from_flax(variables)
    assert via_flax.keys() == state.keys()
    for k in state:
        assert torch.equal(via_flax[k], state[k]), k
    model = port_model(cfg, state)
    back = flax_from_params(model)
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    x, t, kw = inputs(cfg)
    want = jax_forward(cfg, variables, x, t, kw)
    got = port_forward(model, x, t, kw)
    assert got.shape == (B, N_CTX, cfg["output_channels"])
    _close(got, want)


# the presets of the image and text pipelines, whose MLPs the fully fused configuration sends
# to the whole-MLP kernel
FUSED_CASES = [c for c in CASES if c[0] in ("base40M", "base40M-textvec", "upsample")]


@pytest.fixture
def fully_fused():
    """The fully fused configuration on both sides: each block's pre-LN MLP as one call, and
    the port's standalone LayerNorms (``ln_pre``, ``ln_post``) on the kernel backend (on the
    CPU, its plain version; the JAX side keeps XLA's LayerNorm, the same formula)."""
    jattn.set_ln_mlp_fusion("on")
    tattn.set_ln_mlp_fusion("on")
    tln.set_layernorm_backend("kernel")
    yield
    jattn.set_ln_mlp_fusion("off")
    tattn.set_ln_mlp_fusion("off")
    tln.set_layernorm_backend("auto")


# and one with the bf16 exp switch on in both packages, at head dim 64 (attention_mh64.cu's
# exp mode on the card); then base300M at its full width (1024, 16 heads of 64: the MLP that K5
# takes past C = 512 in bf16), one layer, in fp32 and in bf16
# (name, width, heads, softmax dtype, model dtype, layers)
FUSED_SOFTMAX = ([c + ("float32", "float32", 2) for c in FUSED_CASES]
                 + [("base40M", 128, 2, "bfloat16", "float32", 2),
                    ("base300M", 1024, 16, "float32", "float32", 1),
                    ("base300M", 1024, 16, "float32", "bfloat16", 1)])
FUSED_IDS = ([c[0] for c in FUSED_CASES]
             + ["base40M bf16 exp", "base300M full width", "base300M full width bf16"])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name,width,heads,softmax,dtype,layers", FUSED_SOFTMAX, ids=FUSED_IDS)
def test_model_fully_fused_matches_jax(fully_fused, monkeypatch, name, width, heads, softmax,
                                       dtype, layers):
    """The tiny models' forward with the whole-MLP fusion on in both packages, one set of
    weights; every block's MLP goes through ``fused_ln_mlp`` (the JAX side traces its XLA
    composition of the same math off the TPU); under the bf16 exp switch every attention
    takes the exp panel's roundings in both. In bf16 both packages build the model in bf16,
    and the JAX package's fp32 forward is the function both approximate, held as
    ``tests/test_torch_port_bf16.py`` holds the denoiser: ``gap`` = rel L2 (JAX bf16, JAX
    fp32), the port within 1.5 gap of the fp32 function and 2 gap of the JAX bf16 output."""
    cfg = _config(name, width, heads, layers)
    sd = reference_state(cfg)
    variables = jimport(sd)
    model = port_model(cfg, timport(sd), getattr(torch, dtype))
    calls = []
    real = tpe.fused_ln_mlp
    monkeypatch.setattr(tpe, "fused_ln_mlp", lambda *a: calls.append(1) or real(*a))
    x, t, kw = inputs(cfg)
    jmod = jconfigs.model_from_config(cfg, dtype=getattr(jnp, dtype))
    jfa.set_attention_softmax_dtype(softmax)
    tfa.set_attention_softmax_dtype(softmax)
    # under the switch the JAX side runs op by op: jit on the CPU would fold the bf16 round
    # trip of the exponentials away (convert pairs simplified), dropping a rounding the TPU
    # kernel, the port and the eager XLA twin all take
    apply = (jax.jit if softmax == "float32" else lambda f: f)(
        lambda v, x, t, kw: jmod.apply(v, x, t, **kw))
    try:
        want = np.asarray(apply(variables, x, t, {k: jnp.asarray(v) for k, v in kw.items()}),
                          np.float32)
        got = port_forward(model, x, t, kw)
    finally:
        jfa.set_attention_softmax_dtype("float32")
        tfa.set_attention_softmax_dtype("float32")
    assert len(calls) == cfg["layers"]
    if dtype == "float32":
        # fp32 on both sides; the fused MLP's sums over C and F in other orders
        _close(got, want)
        return
    fp32 = jax_forward(cfg, variables, x, t, kw)
    gap = _rel(want, fp32)
    assert 0 < gap < 5e-2, gap  # bf16 rounding, not a broken graph
    assert _rel(got, fp32) <= 1.5 * gap, (_rel(got, fp32), gap)
    assert _rel(got, want) <= 2.0 * gap, (_rel(got, want), gap)


def test_upsampler_without_embeddings_uses_a_zero_grid():
    cfg = _config("upsample", 64, 2)
    sd = reference_state(cfg, seed=3)
    x, t, kw = inputs(cfg, seed=4)
    model = port_model(cfg, timport(sd))
    want = jax_forward(cfg, jimport(sd), x, t, {"low_res": kw["low_res"]})
    _close(port_forward(model, x, t, {"low_res": kw["low_res"]}), want)
    zeros = dict(kw, embeddings=np.zeros_like(kw["embeddings"]))
    _close(port_forward(model, x, t, zeros), want)


def test_wrong_split_scale_or_order_is_seen(monkeypatch):
    """Each load-bearing detail, done another way in the port, moves its output past the
    tolerance: the contiguous split of c_qkv, the split scale folded into q once
    (ch^-1/4) instead of squared, and the conditioning tokens after the points instead of
    before them. (Their order among themselves cannot show: with no positional embedding
    the blocks treat the tokens as a set, and all of them are stripped.)"""
    cfg = _config("upsample", 128, 2)
    sd = reference_state(cfg, seed=5)
    x, t, kw = inputs(cfg, seed=6)
    model = port_model(cfg, timport(sd))
    want = jax_forward(cfg, jimport(sd), x, t, kw)
    _close(port_forward(model, x, t, kw), want)

    def far(fault):
        got = port_forward(port_model(cfg, timport(sd)), x, t, kw)
        assert np.abs(got - want).max() > 1e-3, fault

    real = tpe.qkv_panels
    with monkeypatch.context() as m:
        m.setattr(tpe, "qkv_panels", lambda w, b, h, p, s, interleaved=True:
                  real(w, b, h, p, s, interleaved=False))
        far("contiguous split")
    with monkeypatch.context() as m:
        m.setattr(tpe, "qkv_panels", lambda w, b, h, p, s, interleaved=True:
                  real(w, b, h, p, [s[0] ** 0.5] + list(s[1:]), interleaved))
        far("split scale not squared")
    def appended(self, x, cond):  # every conditioning token after the points
        extra = [e[:, None] if e.dim() == 2 else e for e, _ in cond]
        h = torch.cat([self.input_proj(x)] + extra, dim=1)
        h = self.ln_post(self.backbone(self.ln_pre(h)))
        return self.output_proj(h[:, sum(e.shape[1] for e in extra):])

    with monkeypatch.context() as m:
        m.setattr(tpe.PointDiffusionTransformer, "_forward_with_cond", appended)
        far("tokens appended")


class Draws:
    """A stand-in for the port's noise seam that hands out given arrays in order."""

    def __init__(self, arrays):
        self.queue = [np.array(a) for a in arrays]

    def __call__(self, shape, generator=None, device=None, dtype=torch.float32):
        a = self.queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a).to(device=device, dtype=dtype)


def _splits(key, n, shape):
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, shape))
    return out


def test_two_stage_image_sampler_matches_jax(monkeypatch):
    """base40M then the upsampler, each at a tiny width, as the image example samples them
    (CFG 3 then 0, churn 3 then 0, RGB aux channels, the grid to both stages), a few Karras
    steps, against the JAX ``PointCloudSampler``. The output projections are scaled down
    (``out_scale``) as a trained model's predictions are of the order of the noise: with
    outputs of order 1 the x0 estimate multiplies each 1e-7 difference of epsilon by sigma
    (up to 160) and the clipping to [-1, 1] turns such differences into jumps. Six steps a
    stage: with fewer, the last Heun corrector lands on sigma_min = 1e-3 from a sigma a
    thousand times larger and divides fp32 rounding by 1e-3 (two steps disagree by whole
    units in both directions between the packages)."""
    steps, n_up = (6, 6), N_CTX + 4
    bcfg = _config("base40M", 64, 2)
    ucfg = dict(_config("upsample", 64, 2), n_ctx=n_up, cond_ctx=N_CTX)
    bsd, usd = reference_state(bcfg, 7, 0.01), reference_state(ucfg, 8, 0.01)
    jb, ju = jconfigs.model_from_config(bcfg), jconfigs.model_from_config(ucfg)
    jbv, juv = jimport(bsd), jimport(usd)
    tb, tu = port_model(bcfg, timport(bsd)), port_model(ucfg, timport(usd))
    grid = np.random.default_rng(9).standard_normal((B, GRID ** 2, GRID_DIM)).astype(np.float32)
    over = dict(num_points=[N_CTX, n_up], aux_channels=["R", "G", "B"],
                guidance_scale=[3.0, 0.0], karras_steps=list(steps), sigma_min=[1e-3, 1e-3],
                sigma_max=[120, 160], s_churn=[3, 0])
    js = jsampler.PointCloudSampler(
        models=[lambda x, t, embeddings=None, **_: jb.apply(jbv, x, t, embeddings=embeddings),
                lambda x, t, low_res=None, embeddings=None, **_: ju.apply(
                    juv, x, t, low_res=low_res, embeddings=embeddings)],
        diffusions=[jdiff_from_config(JDIFF["base40M"]), jdiff_from_config(JDIFF["upsample"])],
        **over)
    ts = tsampler.PointCloudSampler(
        models=[lambda x, t, embeddings=None, **_: tb(x, t, embeddings=embeddings),
                lambda x, t, low_res=None, embeddings=None, **_: tu(
                    x, t, low_res=low_res, embeddings=embeddings)],
        diffusions=[tdiff_from_config(TDIFF["base40M"]), tdiff_from_config(TDIFF["upsample"])],
        **over)
    key = jax.random.PRNGKey(11)
    want = js.sample_batch(B, {"embeddings": jnp.asarray(grid)}, key)
    draws, k = [], key
    for stage, shape in enumerate(((B, N_CTX, 6), (B, n_up, 6))):
        k, sub = jax.random.split(k)
        sub, init_key = jax.random.split(sub)
        draws.append(jax.random.normal(init_key, shape))
        if stage == 0:
            draws += _splits(sub, steps[0], shape)  # churned at every step
    feed = Draws(draws)
    monkeypatch.setattr(_noise, "normal", feed)
    got = ts.sample_batch(B, {"embeddings": torch.from_numpy(grid)}, torch.Generator())
    assert not feed.queue
    assert tuple(got.shape) == (B, N_CTX + n_up, 6)
    # in the processes' scaled space (positions x 2, colours / 127.5 - 1), where the
    # solvers work: unscaled, a colour carries each difference 127.5 times
    scaled = tdiff_from_config(TDIFF["base40M"]).scale_channels
    _close(scaled(got).numpy(), scaled(torch.from_numpy(np.array(want))).numpy(), 1e-4)
