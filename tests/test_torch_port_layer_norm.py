"""The port's standalone LayerNorm (K6a forward, K6b backward) against the JAX package (CPU).

On the CPU the autograd wrapper :func:`pcdiff_torch.ops.layer_norm.fused_layer_norm` runs
the plain versions of the CUDA kernels, :func:`layer_norm` and ``_torch_layer_norm_bwd``.
Here they are held against the Pallas kernels they replace, run in interpret mode as
``tests/test_layer_norm.py`` runs them, with row counts that do not divide the kernels'
1024-row block, against JAX autodiff through ``fused_layer_norm``'s custom VJP, and the
wrapper against finite differences (``gradcheck``, float64). The ``LayerNorm`` module is
held against the JAX ``FusedLayerNorm`` under the same backend switch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff.models import attention as jattn
from pcdiff.ops import layer_norm as jln
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.ops import layer_norm as tln

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


@pytest.fixture
def kernel_backends():
    """The fully fused configuration's LayerNorm switch on both sides."""
    jln.set_layernorm_backend("pallas")
    tln.set_layernorm_backend("kernel")
    yield
    jln.set_layernorm_backend("auto")
    tln.set_layernorm_backend("auto")


def _inputs(rng, rows, c):
    x = (rng.standard_normal((rows, c)) * 3.0 + 0.7).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal((rows, c)).astype(np.float32)
    return x, scale, bias, g


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("rows,c", [(37, 128), (1100, 256)])
def test_layer_norm_fwd_matches_pallas(rng, rows, c):
    x, scale, bias, _ = _inputs(rng, rows, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jln._pallas_layer_norm(*map(jnp.asarray, (x, scale, bias)), 1e-5,
                                                 jnp.float32))
    got = tln.layer_norm(*_t(x, scale, bias), 1e-5, torch.float32).numpy()
    # the same fp32 formula; the row sums run in another order and rsqrt may differ by an ulp
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_fwd_bf16_matches_pallas(rng):
    x, scale, bias, _ = _inputs(rng, 1100, 256)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jln._pallas_layer_norm(xb, jnp.asarray(scale), jnp.asarray(bias),
                                                 1e-5, jnp.bfloat16), np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = tln.layer_norm(xt, *_t(scale, bias), 1e-5, torch.bfloat16).float().numpy()
    # bf16 in and out, fp32 in between: a last-bit difference in fp32 can move the one
    # bf16 rounding on output by one bf16 ulp (2^-8 relative)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-2)
    assert np.mean(got != want) < 0.01


@pytest.mark.parametrize("rows,c", [(64, 128), (1100, 256)])
def test_layer_norm_bwd_matches_pallas(rng, rows, c):
    x, scale, _, g = _inputs(rng, rows, c)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(t) for t in jln._pallas_layer_norm_bwd(
            *map(jnp.asarray, (x, scale, g)), 1e-5)]
    got = [t.numpy() for t in tln._torch_layer_norm_bwd(*_t(x, scale, g), 1e-5)]
    # the same fp32 formula; dscale and dbias sum up to 1100 rows in another order (the
    # kernel sums per 1024-row cell, then the cells)
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_layer_norm_autograd_matches_jax(rng):
    """The CPU wrapper's gradient == jax.grad through fused_layer_norm's custom VJP, with
    a [B, N, C] input."""
    x, scale, bias, g = _inputs(rng, 2 * 37, 128)
    x, g = x.reshape(2, 37, 128), g.reshape(2, 37, 128)

    def f(x_, s_, b_):
        return jnp.sum(jln.fused_layer_norm(x_, s_, b_, 1e-5, jnp.float32) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    tx, ts, tb = (t.requires_grad_() for t in _t(x, scale, bias))
    (tln.fused_layer_norm(tx, ts, tb, 1e-5, torch.float32) * torch.from_numpy(g)).sum().backward()
    # the same formula in fp32 on both sides, sums in other orders
    for name, a, w in zip(("dx", "dscale", "dbias"), (tx, ts, tb), want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert tln.launches == 0 and tln.bwd_launches == 0  # no kernel on a CPU tensor


def test_layer_norm_autograd_gradcheck():
    """The autograd wrapper (plain path) against finite differences, float64."""
    g = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64, generator=g)
    x = (torch.randn(2, 3, 8, **f64) * 2 + 0.5).requires_grad_()
    scale = (1 + 0.2 * torch.randn(8, **f64)).requires_grad_()
    bias = (0.2 * torch.randn(8, **f64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b, c: tln.fused_layer_norm(a, b, c, 1e-5, torch.float64), (x, scale, bias))


def test_layernorm_backend_switch():
    assert tln.layernorm_backend() == "auto"
    with pytest.raises(ValueError, match="unknown LayerNorm backend"):
        tln.set_layernorm_backend("pallas")
    # a CPU tensor runs the plain version under every backend: no gate, no launch
    x = torch.randn(3, 128)
    for name in ("kernel", "plain", "auto"):
        tln.set_layernorm_backend(name)
        assert not tln._use_kernel(x)
    assert tln.launches == 0


class _JLn(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jattn.LayerNorm(dtype=jnp.float32, name="ln")(x)


@pytest.mark.parametrize("c", [128, 96])  # the Pallas kernel's lane-aligned C, and XLA's
def test_layer_norm_module_matches_jax(rng, kernel_backends, c):
    x = rng.standard_normal((2, 37, c)).astype(np.float32)
    params = {"ln": {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                     "bias": (0.2 * rng.standard_normal(c)).astype(np.float32)}}
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_JLn().apply({"params": params}, jnp.asarray(x)))
    mod = tattn.LayerNorm(c)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(params["ln"]["scale"]))
        mod.bias.copy_(torch.from_numpy(params["ln"]["bias"]))
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
