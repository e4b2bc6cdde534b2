"""K1's bf16 exp mode: the port's plain versions against the JAX package (CPU).

Under ``set_attention_softmax_dtype("bfloat16")`` the JAX package's multi-head kernel
(``_mh_kernel``) subtracts the final row max from the fp32 scores, rounds to bf16, takes exp
in bf16, sums the rounded weights in fp32 and divides after PV; its XLA twin
(``_xla_attention_mh``, the path for shapes the kernel does not take) normalises before PV.
The port's counterparts are ``_torch_attention_mh(..., exp_dtype=torch.bfloat16)`` (the
plain version of K1's mode) and ``_torch_attention_mh_xla`` (its fallback off K1's domain).
They are held to the interpret-mode Pallas kernel and to the XLA twin with the JAX switch set
and restored, fp32 and bf16 operands, ragged lengths, inputs from numpy with a seed. The XLA
twin rounds the exponentials to bf16 as the TPU does, and the port matches it up to rare
rounding flips; the interpret-mode kernel on the CPU does not round them (see the first
test), and the port matches it within one such rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff.ops import flash_attention as jfa
from pcdiff_torch.ops import flash_attention as tfa

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


@pytest.fixture
def jax_bf16_exp():
    """The JAX switch on, restored after. The switch is read when a function is traced, so
    JAX's caches are cleared too: no program traced under it serves a later test."""
    jfa.set_attention_softmax_dtype("bfloat16")
    try:
        yield
    finally:
        jfa.set_attention_softmax_dtype("float32")
        jax.clear_caches()


def _qkv(rng, b, nq, nk, hd):
    q = rng.standard_normal((b, nq, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, nk, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, nk, hd)).astype(np.float32)
    return q, k, v


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("nq,nk,heads,hd,mxu", [
    (37, 131, 4, 128, "float32"),   # ragged both ways, read-like
    (131, 37, 4, 128, "bfloat16"),  # write-like, the kernel's bf16 operands
    (45, 45, 8, 256, "bfloat16"),   # the flagship's 8 heads of 32
    (37, 131, 2, 128, "bfloat16"),  # head dim 64, the Point-E path's (attention_mh64.cu)
])
def test_bf16_exp_plain_matches_pallas(rng, jax_bf16_exp, nq, nk, heads, hd, mxu):
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(rng, 2, nq, nk, hd))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._pallas_attention_mh(jq, jk, jv, heads,
                                                   mxu_dtype=getattr(jnp, mxu)))
    got = tfa._torch_attention_mh(tq, tk, tv, heads, mxu_dtype=getattr(torch, mxu),
                                  exp_dtype=torch.bfloat16).numpy()
    # On the CPU, XLA computes the kernel's bf16 exp in fp32 and drops the round trip of its
    # result through bf16 (convert pairs are simplified away), so the interpret-mode kernel
    # rounds s - m but not p, where the TPU and the XLA twin (below, exact) round both. That
    # rounding, 2^-9 of each weight at most, moves an output by ~2^-9 of a weighted mean of
    # |v| < 5 at most (measured 1.0e-3; mean 1.8e-4); the roundings of s - m agree.
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert np.abs(got - want).mean() < 5e-4


def test_bf16_exp_mode_is_not_the_default_mode(rng):
    """The mode changes the function: its weights carry bf16 roundings the default lacks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 45, 45, 256))
    exp = tfa._torch_attention_mh(q, k, v, 8, torch.float32, exp_dtype=torch.bfloat16)
    default = tfa._torch_attention_mh(q, k, v, 8, torch.float32)
    diff = (exp - default).abs().max().item()
    assert 1e-4 < diff < 5e-2  # ~2^-9 relative of a weighted mean of |v| < 5


@pytest.mark.parametrize("nq,nk,heads,hd", [(37, 131, 8, 128), (45, 45, 8, 256)])
def test_xla_twin_fallback_matches_jax(rng, jax_bf16_exp, nq, nk, heads, hd):
    """Off K1's domain (head dim 16 here) the port takes the XLA twin's function."""
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(rng, 2, nq, nk, hd))
    want = np.asarray(jfa._xla_attention_mh(jq, jk, jv, heads))
    got = tfa._torch_attention_mh_xla(tq, tk, tv, heads, torch.float32).numpy()
    # fp32 on both sides; the bf16 roundings of s - m and exp can flip on an fp32 sum-order
    # difference in a score, as above
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert np.abs(got - want).mean() < 1e-5


def test_kernel_mode_plain_version_against_the_xla_twin(rng, jax_bf16_exp):
    """K1's plain version divides after PV where the XLA twin normalises before it: with
    fp32 operands the two differ only by that order and by rounding flips."""
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(rng, 2, 37, 131, 128))
    want = np.asarray(jfa._xla_attention_mh(jq, jk, jv, 4))
    got = tfa._torch_attention_mh(tq, tk, tv, 4, mxu_dtype=torch.float32,
                                  exp_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert np.abs(got - want).mean() < 1e-5


def test_wrapper_follows_the_switch_on_cpu(rng):
    """The autograd wrapper on a CPU tensor runs the plain version of the switch's mode, and
    its backward (K2's plain version) ignores the switch, as the JAX backward does."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng, 2, 19, 23, 128))
    g = torch.from_numpy(rng.standard_normal((2, 19, 128)).astype(np.float32))
    tfa.set_attention_softmax_dtype("bfloat16")
    try:
        out = tfa.fused_attention_mh(q, k, v, 4)
        grads = torch.autograd.grad(out, (q, k, v), g)
    finally:
        tfa.set_attention_softmax_dtype("float32")
    want = tfa._torch_attention_mh(q, k, v, 4, torch.float32, exp_dtype=torch.bfloat16)
    assert torch.equal(out, want)
    for got, ref in zip(grads, tfa._torch_attention_mh_bwd(q, k, v, g, 4, torch.float32)):
        assert torch.equal(got, ref)
    assert tfa.launches == 0
