"""The port's modules against the JAX package's, on the CPU in fp32.

Both sides get the same parameters (the flax tree, through ``params_from_flax``) and the
same inputs (numpy, seeded). The JAX side runs the graph the TPU runs:
``set_ln_dense_fusion("on")`` fuses every pre-LN into its projections. LayerNorm affines
and biases are moved off their init so that every path is live. Tolerance: 1e-5 for a
module and for the whole tiny denoiser (fp32 on both sides, only summation orders and
the erf form differ, also through the denoiser's 30-odd layers).
Parameter trees are traced with ``jax.eval_shape`` and filled from numpy: running
flax's init costs more than the tests.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch import nn

from pcdiff.models import attention as jattn
from pcdiff.models import rin as jrin
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff_torch.core import params_from_flax
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models import rin as trin
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

# Both heavy encoders see 5 tokens (4 points or 2 x 2 patches, + CLS) and decode 4, so
# their ops share shapes and JAX compiles them once.
TINY = dict(num_points=32, num_latents=8, latent_dim=32, x_dim=32, num_blocks=2,
            num_compute_layers=1, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16)


@pytest.fixture(autouse=True)
def _fused_graph():
    jattn.set_ln_dense_fusion("on")
    yield
    jattn.set_ln_dense_fusion("auto")


@pytest.fixture(params=["erf", "tanh"])
def gelu(request):
    jattn.set_gelu_impl(request.param)
    tattn.set_gelu_impl(request.param)
    yield request.param
    jattn.set_gelu_impl("erf")
    tattn.set_gelu_impl("erf")


def _params(jmod, rng, *args):
    """A random parameter tree of ``jmod``'s shapes (traced, not run): fan-in scaled
    kernels, LayerNorm scales near 1 and biases near 0 but off their init, so that every
    path is live (``ln_latent`` too)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"]
    flat = {}
    for path, sd in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if path[-1] == "kernel":
            flat[path] = z / np.sqrt(np.prod(sd.shape[:-1]))
        elif path[-1] == "scale":
            flat[path] = 1.0 + 0.1 * z
        elif path[-1] == "bias":
            flat[path] = 0.1 * z
        else:  # embeddings, z_init, cls_token, token_queries
            flat[path] = 0.3 * z
    return traverse_util.unflatten_dict(flat)


def _japply(jmod, params, *args):
    # jit compiles the module once; eager flax compiles each op separately (slower)
    return jax.jit(jmod.apply)({"params": params}, *args)


def _port(tmod, params):
    tmod.load_state_dict(params_from_flax(params), strict=True)
    return tmod.eval()


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


class _JAttn(fnn.Module):
    mode: str

    @fnn.compact
    def __call__(self, xq, xkv):
        ln_q = jattn._LNParams(name="ln_q")(xq.shape[-1])
        ln_kv = jattn._LNParams(name="ln_kv")(xkv.shape[-1])
        attn = jattn.CrossAttention(32, num_heads=4, qkv_bias=True, name="attn")
        if self.mode == "self":
            return attn(xq, xq, q_ln=ln_q, kv_ln=ln_q)
        return attn(xq, xkv, q_ln=ln_q, kv_ln=ln_kv if self.mode == "cross" else None)


class _TAttn(nn.Module):
    def __init__(self, mode, kv_dim):
        super().__init__()
        self.mode = mode
        self.ln_q = tattn.LayerNorm(32)
        self.ln_kv = tattn.LayerNorm(kv_dim)
        self.attn = tattn.CrossAttention(32, num_heads=4, qkv_bias=True,
                                         kv_dim=32 if mode == "self" else kv_dim)

    def forward(self, xq, xkv):
        if self.mode == "self":
            return self.attn(xq, xq, q_ln=self.ln_q, kv_ln=self.ln_q)
        return self.attn(xq, xkv, q_ln=self.ln_q,
                         kv_ln=self.ln_kv if self.mode == "cross" else None)


@pytest.mark.parametrize("mode", ["self", "cross", "raw_memory"])
def test_cross_attention(rng, mode):
    xq, xkv = _arr(rng, 2, 13, 32), _arr(rng, 2, 29, 48)
    jmod = _JAttn(mode)
    params = _params(jmod, rng, xq, xkv)
    tmod = _port(_TAttn(mode, 48), params)
    want = _japply(jmod, params, xq, xkv)
    _close(tmod(torch.from_numpy(xq), torch.from_numpy(xkv)), want)


class _JMlp(fnn.Module):
    fused: bool

    @fnn.compact
    def __call__(self, x):
        ln = jattn._LNParams(name="ln")(x.shape[-1]) if self.fused else None
        return jattn.Mlp(128, name="mlp")(x, ln=ln)


class _TMlp(nn.Module):
    def __init__(self, fused):
        super().__init__()
        self.fused = fused
        self.ln = tattn.LayerNorm(32)
        self.mlp = tattn.Mlp(32, 128)

    def forward(self, x):
        return self.mlp(x, ln=self.ln if self.fused else None)


@pytest.mark.parametrize("fused", [True, False])
def test_mlp(rng, gelu, fused):
    x = _arr(rng, 2, 17, 32)
    jmod = _JMlp(fused)
    params = _params(jmod, rng, x)
    tmod = _TMlp(fused)
    if not fused:
        del tmod.ln
    _close(_port(tmod, params)(torch.from_numpy(x)), _japply(jmod, params, x))


def test_encoder_layer(rng, gelu):
    x = _arr(rng, 2, 21, 32)
    jmod = jattn.EncoderLayer(32, 4)
    params = _params(jmod, rng, x)
    tmod = _port(tattn.EncoderLayer(32, 4), params)
    _close(tmod(torch.from_numpy(x)), _japply(jmod, params, x))


def test_decoder_layer(rng, gelu):
    q, mem = _arr(rng, 2, 7, 32), _arr(rng, 2, 23, 32)
    jmod = jattn.DecoderLayer(32, 4)
    params = _params(jmod, rng, q, mem)
    tmod = _port(tattn.DecoderLayer(32, 4), params)
    _close(tmod(torch.from_numpy(q), torch.from_numpy(mem)), _japply(jmod, params, q, mem))


def test_rcw_block(rng, gelu):
    z, x = _arr(rng, 2, 11, 32), _arr(rng, 2, 27, 48)
    jmod = jrin.RCWBlock(32, 48, num_compute_layers=2, num_heads=4, qkv_bias=True)
    params = _params(jmod, rng, z, x)
    tmod = _port(trin.RCWBlock(32, 48, 2, 4, 4.0, True), params)
    jz, jx = _japply(jmod, params, z, x)
    tz, tx = tmod(torch.from_numpy(z), torch.from_numpy(x))
    _close(tz, jz)
    _close(tx, jx)


def _tiny_batch(rng, b):
    return dict(
        class_labels=rng.integers(0, 10, (b,)).astype(np.int32),
        viewpoints=_arr(rng, b, 3),
        partial_pcd=(rng.uniform(-0.5, 0.5, (b, 4, 3))).astype(np.float32),
        depth_maps=rng.random((b, 32, 32, 1)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def tiny():
    """One tiny TwoStreamDenoiser on both sides with the same random parameters; every
    test below runs it at these shapes, so JAX compiles its ops once."""
    rng = np.random.default_rng(1)
    batch = _tiny_batch(rng, 2)
    x, t = _arr(rng, 2, 32, 3), np.array([3, 817], dtype=np.int32)
    jmod = JTwoStream(**TINY)
    params = _params(jmod, rng, x, t, *batch.values())
    tmod = _port(TTwoStream(**TINY, device="cpu"), params)
    prev = 0.5 * _arr(rng, 2, tmod.latent_tokens, 32)
    return jmod, params, tmod, batch, x, t, prev


def test_two_stream_denoiser(tiny, gelu):
    jmod, params, tmod, batch, x, t, prev = tiny
    fwd = jax.jit(lambda p, x, t, prev, kw: jmod.apply({"params": p}, x, t, prev_latent=prev,
                                                          **kw))
    want_eps, want_lat = fwd(params, x, t, prev, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        eps, lat = tmod(torch.from_numpy(x), torch.from_numpy(t),
                        prev_latent=torch.from_numpy(prev), **tb)
    _close(eps, want_eps)
    _close(lat, want_lat)


def test_encode_conditioning_presence(tiny):
    """Presence masks: an explicit per-row override (partial_pcd), the batch-level
    any-nonzero default (an all-zero depth batch is absent) and a missing modality."""
    jmod, params, tmod, batch, _, _, _ = tiny
    batch = dict(batch, depth_maps=np.zeros_like(batch["depth_maps"]))
    del batch["viewpoints"]
    presence = {"partial_pcd": np.array([1.0, 0.0], np.float32)}
    enc = jax.jit(lambda p, pres, kw: jmod.apply({"params": p}, 2, presence=pres,
                                                 method=JTwoStream.encode_conditioning, **kw))
    want = enc(params, {k: jnp.asarray(v) for k, v in presence.items()}, batch)
    with torch.no_grad():
        got = tmod.encode_conditioning(
            2, presence={k: torch.from_numpy(v) for k, v in presence.items()},
            **{k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want)
    assert torch.count_nonzero(got[1, 2:6]) == 0  # the absent partial_pcd row
    assert torch.count_nonzero(got[:, 1]) == 0  # no viewpoints
    assert torch.count_nonzero(got[:, 6:]) == 0  # all-zero depth maps
