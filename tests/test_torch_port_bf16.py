"""The port's bf16 graph against the JAX package's bf16 graph (CPU).

The tiny ``TwoStreamDenoiser`` runs in bf16 on both sides with the same weights (through
``params_from_flax``) and inputs, in the default configuration and in the fully fused one
(``set_ln_mlp_fusion("on")`` and the LayerNorm kernel backend), and the JAX package's fp32
forward gives the exact function both approximate. The two frameworks round at other places
(the port's ``F.linear`` adds the bias in the GEMM's fp32 epilogue where flax adds it in
bf16; ``F.gelu`` computes a bf16 input in fp32; XLA may keep excess precision between
fused ops), so the bf16 outputs are compared at a tolerance drawn from the JAX package's
own bf16 error on these inputs, ``gap = relL2(JAX bf16, JAX fp32)``:

- the port's bf16 output is no farther from the fp32 function than 1.5 gap: its graph
  loses no more than half as much again as the JAX package's;
- the port's and the JAX package's bf16 outputs are within 2 gap of each other: two bf16
  graphs that each stand ~gap from the function, with roundings that are not the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdiff.models import attention as jattn
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff.ops import layer_norm as jln
from pcdiff_torch.core import params_from_flax
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.ops import layer_norm as tln

from .test_torch_port_models import TINY, _params, _tiny_batch

torch.set_num_threads(2)


@pytest.fixture(params=["default", "fully_fused"])
def config(request):
    fused = request.param == "fully_fused"
    jattn.set_ln_dense_fusion("on")
    jattn.set_ln_mlp_fusion("on" if fused else "off")
    jln.set_layernorm_backend("pallas" if fused else "auto")
    tattn.set_ln_mlp_fusion("on" if fused else "off")
    tln.set_layernorm_backend("kernel" if fused else "auto")
    yield request.param
    jattn.set_ln_mlp_fusion("off")
    jattn.set_ln_dense_fusion("auto")
    jln.set_layernorm_backend("auto")
    tattn.set_ln_mlp_fusion("off")
    tln.set_layernorm_backend("auto")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    batch = _tiny_batch(rng, 2)
    x, t = rng.standard_normal((2, 32, 3)).astype(np.float32), np.array([3, 817], np.int32)
    params = _params(JTwoStream(**TINY), rng, x, t, *batch.values())
    tokens = 8 + 2 + 4 + 4 + 1  # latents, class and view, ppcd, depth, time
    prev = (0.5 * rng.standard_normal((2, tokens, 32))).astype(np.float32)
    return params, batch, x, t, prev


def _jax_forward(params, batch, x, t, prev, dtype):
    jmod = JTwoStream(**TINY, dtype=dtype)
    fwd = jax.jit(lambda p, x, t, prev, kw: jmod.apply({"params": p}, x, t, prev_latent=prev,
                                                          **kw))
    return [np.asarray(o, np.float32)
            for o in fwd(params, x, t, jnp.asarray(prev).astype(dtype), batch)]


@pytest.fixture(scope="module")
def fp32_function(setup):
    """The JAX package's fp32 forward: the function both bf16 graphs approximate (the two
    configurations compute the same one)."""
    jattn.set_ln_dense_fusion("on")
    yield _jax_forward(*setup, jnp.float32)
    jattn.set_ln_dense_fusion("auto")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_denoiser_matches_jax_bf16(setup, fp32_function, config):
    params, batch, x, t, prev = setup
    outs = {"fp32": fp32_function, "bf16": _jax_forward(*setup, jnp.bfloat16)}
    tmod = TTwoStream(**TINY, dtype=torch.bfloat16, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x), torch.from_numpy(t),
                          prev_latent=torch.from_numpy(prev).to(torch.bfloat16),
                          **{k: torch.from_numpy(v) for k, v in batch.items()})
    for i, name in enumerate(("eps", "latent")):
        port, jb, j32 = got[i].float().numpy(), outs["bf16"][i], outs["fp32"][i]
        gap = _rel(jb, j32)
        assert 0 < gap < 5e-2, (name, gap)  # bf16 rounding, not a broken graph
        assert _rel(port, j32) <= 1.5 * gap, (name, _rel(port, j32), gap)
        assert _rel(port, jb) <= 2.0 * gap, (name, _rel(port, jb), gap)
