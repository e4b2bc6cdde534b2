"""The port's kernel functions against the JAX package's Pallas kernels (CPU).

On the CPU the port's wrappers run the plain PyTorch versions of the CUDA kernels; here
those are held against the Pallas kernels they replace, run in interpret mode as
``tests/test_ops.py`` and ``tests/test_ln_dense.py`` run them. The Pallas path needs
HD % 128 == 0, D % 32 == 0 and C, F % 128 == 0, so the shapes keep to that; N is ragged.
Inputs come from numpy with a seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff.ops import flash_attention as fa
from pcdiff.ops import ln_dense as ld
from pcdiff_torch.ops import flash_attention as tfa
from pcdiff_torch.ops import layer_norm as tln
from pcdiff_torch.ops import ln_dense as tld

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


def _qkv(rng, b, nq, nk, hd):
    q = rng.standard_normal((b, nq, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, nk, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, nk, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nq,nk,heads,hd", [
    (37, 131, 4, 128),   # ragged both ways, read-like (fewer queries than keys)
    (131, 37, 4, 128),   # write-like
    (45, 45, 8, 256),    # the flagship's 8 heads of 32
])
def test_attention_fp32_operands_match_pallas(rng, nq, nk, heads, hd):
    q, k, v = _qkv(rng, 2, nq, nk, hd)
    with pltpu.force_tpu_interpret_mode():
        want = fa._pallas_attention_mh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads, mxu_dtype=jnp.float32)
    got = tfa._torch_attention_mh(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads, mxu_dtype=torch.float32)
    # fp32 products and softmax on both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_bf16_operands_match_pallas(rng):
    """The kernel's numerics class: bf16 operands (fp32 inputs), bf16 P for PV."""
    q, k, v = _qkv(rng, 2, 37, 131, 128)
    with pltpu.force_tpu_interpret_mode():
        want = fa._pallas_attention_mh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    got = tfa._torch_attention_mh(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 4)
    # same roundings; an fp32 sum-order difference can flip one bf16 rounding of P,
    # which moves an output by at most ~2^-8 of one weighted value of v (|v| < 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)
    assert np.abs(got.numpy() - np.asarray(want)).mean() < 1e-5


def test_attention_wrapper_on_cpu_keeps_input_dtype(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 19, 23, 64))
    got = tfa.fused_attention_mh(q, k, v, 2)
    want = tfa._torch_attention_mh(q, k, v, 2, mxu_dtype=torch.float32)
    assert torch.equal(got, want)
    assert tfa.launches == 0  # no kernel on a CPU tensor


def _ln_inputs(rng, b, n, c, fs, with_bias):
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    ks = [(rng.standard_normal((c, f)) * 0.1).astype(np.float32) for f in fs]
    bs = [(rng.standard_normal(f)).astype(np.float32) if on else None
          for f, on in zip(fs, with_bias)]
    return x, scale, bias, ks, bs


def _both_ln_denses(x, scale, bias, ks, bs, acts, out_dtype):
    try:
        ld.set_lndense_backend("pallas")
        with pltpu.force_tpu_interpret_mode():
            want = ld.fused_ln_denses(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                tuple(jnp.asarray(k) for k in ks),
                tuple(None if b is None else jnp.asarray(b) for b in bs),
                1e-5, jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16,
                tuple(acts))
    finally:
        ld.set_lndense_backend("auto")
    got = tld.fused_ln_denses(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        [torch.from_numpy(np.ascontiguousarray(k.T)) for k in ks],
        [None if b is None else torch.from_numpy(b) for b in bs], 1e-5, out_dtype, acts)
    return [np.asarray(w.astype(jnp.float32)) for w in want], [g.float().numpy() for g in got]


@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
@pytest.mark.parametrize("n,fs,with_bias", [
    (37, (256,), (True,)),
    (131, (128, 128, 128), (True, False, True)),
])
def test_ln_denses_fp32_match_pallas(rng, act, n, fs, with_bias):
    x, scale, bias, ks, bs = _ln_inputs(rng, 2, n, 128, fs, with_bias)
    want, got = _both_ln_denses(x, scale, bias, ks, bs, [act] * len(fs), torch.float32)
    for g, w in zip(got, want):
        # fp32 LN and products on both sides; the activation is the same rational
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_ln_denses_bf16_match_pallas(rng):
    x, scale, bias, ks, bs = _ln_inputs(rng, 2, 37, 128, (256, 128), (True, True))
    want, got = _both_ln_denses(x, scale, bias, ks, bs, ["gelu_tanh", None], torch.bfloat16)
    for g, w in zip(got, want):
        # bf16 product and output: equal up to one bf16 rounding (2^-8 relative)
        np.testing.assert_allclose(g, w, rtol=8e-3, atol=8e-3)


def test_activation_epilogue_matches_jax(rng):
    z = np.concatenate([np.linspace(-40, 40, 4001), rng.standard_normal(4000) * 3])
    z = z.astype(np.float32)
    for act in ("gelu", "gelu_tanh", "quick_gelu"):
        want = np.asarray(ld._apply_act(jnp.asarray(z), act, erf=ld._erf_f32))
        got = tld._apply_act(torch.from_numpy(z), act).numpy()
        # the same fp32 formula in the same order: ulp-level agreement
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_layer_norm_matches_xla(rng):
    from pcdiff.ops import layer_norm as jln

    x = (rng.standard_normal((3, 29, 64)) * 2 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jln._xla_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5,
                               jnp.float32)
    got = tln.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 1e-5, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
