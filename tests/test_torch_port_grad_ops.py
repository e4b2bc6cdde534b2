"""The port's backward kernels' plain versions against the JAX package (CPU).

On the CPU the port's autograd wrappers run the plain PyTorch versions of the CUDA
backward kernels K2 (``_torch_attention_mh_bwd``) and K4 (``_torch_ln_denses_bwd``). Here
they are held against the Pallas backward kernels they replace, run in interpret mode as
``tests/test_ops.py`` and ``tests/test_ln_dense.py`` run them, and against JAX autodiff
through the public ops. The Pallas path needs HD % 128 == 0, D % 32 == 0 and C, F % 128
== 0, so the shapes keep to that; N is ragged. Inputs come from numpy with a seed and go to
both packages. The wrappers themselves are checked with ``torch.autograd.gradcheck`` in
float64 at toy sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff.ops import flash_attention as fa
from pcdiff.ops import ln_dense as ld
from pcdiff_torch.ops import flash_attention as tfa
from pcdiff_torch.ops import ln_dense as tld

torch.set_num_threads(2)


def _qkvg(rng, b, nq, nk, hd):
    q = rng.standard_normal((b, nq, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, nk, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, nk, hd)).astype(np.float32)
    g = rng.standard_normal((b, nq, hd)).astype(np.float32)
    return q, k, v, g


def _torch_bwd(arrs, heads, mxu):
    return [t.numpy() for t in tfa._torch_attention_mh_bwd(
        *(torch.from_numpy(a) for a in arrs), heads, mxu_dtype=mxu)]


def _pallas_bwd(arrs, heads, mxu):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(t) for t in fa._pallas_attention_mh_bwd(
            *(jnp.asarray(a) for a in arrs), heads, mxu_dtype=mxu)]


def _assert_grads(got, want, rtol, atol_rel, names=("dq", "dk", "dv")):
    """|got - want| <= rtol |want| + atol_rel max|want|, per gradient."""
    for name, a, w in zip(names, got, want):
        np.testing.assert_allclose(a, w, rtol=rtol,
                                   atol=atol_rel * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


@pytest.mark.parametrize("nq,nk,heads,hd", [
    (37, 131, 4, 128),   # ragged both ways, read-like
    (131, 37, 4, 128),   # write-like
    (45, 45, 8, 256),    # the flagship's 8 heads of 32
])
def test_attention_bwd_fp32_operands_match_pallas(rng, nq, nk, heads, hd):
    arrs = _qkvg(rng, 2, nq, nk, hd)
    want = _pallas_bwd(arrs, heads, jnp.float32)
    got = _torch_bwd(arrs, heads, torch.float32)
    # fp32 products and softmax on both sides; only the summation order differs
    _assert_grads(got, want, rtol=1e-5, atol_rel=1e-5)


def test_attention_bwd_matches_jax_autodiff(rng):
    """The CPU wrapper's backward == jax.grad through fused_attention_mh (its XLA branch
    off the TPU), fp32."""
    q, k, v, g = _qkvg(rng, 2, 29, 53, 128)

    def f(q_, k_, v_):
        return jnp.sum(fa.fused_attention_mh(q_, k_, v_, 4) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tfa.fused_attention_mh(tq, tk, tv, 4) * torch.from_numpy(g)).sum().backward()
    # fp32 on both sides; softmax as p / sum against p * (1 / sum), sums in other orders
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], [np.asarray(w) for w in want],
                  rtol=1e-5, atol_rel=1e-5)
    assert tfa.bwd_launches == 0  # no kernel on a CPU tensor


def test_attention_bwd_bf16_operands_match_pallas(rng):
    """The kernels' numerics class: bf16 q, k, v, g; P and ds rounded to bf16."""
    arrs = _qkvg(rng, 2, 37, 131, 128)
    want = _pallas_bwd(arrs, 4, jnp.bfloat16)
    got = _torch_bwd(arrs, 4, torch.bfloat16)
    # the same roundings; a summation-order difference in fp32 can flip one bf16 rounding
    # of P or ds (2^-8 relative), which moves a gradient by ~2^-8 of one product term
    _assert_grads(got, want, rtol=0, atol_rel=4e-3)
    for a, w in zip(got, want):
        assert np.abs(a - w).mean() < 2e-4 * np.abs(w).mean()


def _ln_inputs(rng, b, n, c, fs, with_bias):
    x = (rng.standard_normal((b, n, c)) * 2 + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    ks = [(rng.standard_normal((c, f)) * 0.1).astype(np.float32) for f in fs]
    bs = [(rng.standard_normal(f)).astype(np.float32) if on else None
          for f, on in zip(fs, with_bias)]
    gs = [rng.standard_normal((b, n, f)).astype(np.float32) for f in fs]
    return x, scale, bias, ks, bs, gs


def _torch_ln_bwd(x, scale, bias, ks, bs, gs, acts, out_dtype):
    dx, ds, db_, dws, dbs = tld._torch_ln_denses_bwd(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        [torch.from_numpy(np.ascontiguousarray(k.T)) for k in ks],
        [None if b is None else torch.from_numpy(b) for b in bs],
        [torch.from_numpy(g).to(out_dtype) for g in gs], 1e-5, out_dtype, acts)
    # back to the JAX package's [C, F] kernel layout
    return ([dx.float().numpy(), ds.numpy(), db_.numpy()], [w.numpy().T for w in dws],
            [None if d is None else d.numpy() for d in dbs])


def _compare_ln(got, want, rtol, atol_rel):
    (g_main, g_dw, g_db), (w_main, w_dw, w_db) = got, want
    _assert_grads(g_main, w_main, rtol, atol_rel, names=("dx", "dscale", "dbias"))
    _assert_grads(g_dw, w_dw, rtol, atol_rel, names=[f"dW{i}" for i in range(len(g_dw))])
    for i, (a, w) in enumerate(zip(g_db, w_db)):
        assert (a is None) == (w is None)
        if a is not None:
            _assert_grads([a], [w], rtol, atol_rel, names=[f"db{i}"])


def _split_jax(outs, with_bias):
    dx, dscale, dbias, dws, dbs = outs
    return ([np.asarray(dx, np.float32), np.asarray(dscale), np.asarray(dbias)],
            [np.asarray(w) for w in dws],
            [np.asarray(d) if hb else None for d, hb in zip(dbs, with_bias)])


LN_CASES = [  # (output widths, activations, biases): every activation, 1-3 projections
    ((256,), ("gelu",), (True,)),
    ((128, 128), ("gelu_tanh", None), (False, True)),
    ((128, 256, 128), ("quick_gelu", "gelu", None), (True, False, True)),
]


@pytest.mark.parametrize("fs,acts,with_bias", LN_CASES)
def test_ln_denses_bwd_fp32_matches_pallas_and_autodiff(rng, fs, acts, with_bias):
    x, scale, bias, ks, bs, gs = _ln_inputs(rng, 2, 37, 128, fs, with_bias)
    jargs = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
             tuple(jnp.asarray(k) for k in ks),
             tuple(None if b is None else jnp.asarray(b) for b in bs))
    with pltpu.force_tpu_interpret_mode():
        pallas = ld._pallas_ln_denses_bwd(*jargs, [jnp.asarray(g) for g in gs], 1e-5,
                                          jnp.float32, acts)

    def ref(x_, s_, b_, ks_, bs_):
        return ld._xla_ln_denses(x_, s_, b_, ks_, bs_, 1e-5, jnp.float32, acts)

    _, vjp = jax.vjp(ref, *jargs)
    autodiff = vjp([jnp.asarray(g) for g in gs])
    got = _torch_ln_bwd(x, scale, bias, ks, bs, gs, list(acts), torch.float32)
    # fp32 LN, products and activation derivative on every side; the Pallas kernel is the
    # same formula (sums in another order), autodiff differentiates the LN statistics
    # itself (equal in exact arithmetic); the weight gradients sum 74 rows
    _compare_ln(got, _split_jax(pallas, with_bias), rtol=1e-5, atol_rel=1e-5)
    _compare_ln(got, _split_jax(autodiff, with_bias), rtol=2e-5, atol_rel=2e-5)


def test_ln_denses_bwd_bf16_matches_pallas(rng):
    """The bf16 model's class: y, W and g act'(z) rounded to bf16, fp32 accumulation."""
    fs, acts, with_bias = (256, 128), ("gelu_tanh", None), (True, True)
    x, scale, bias, ks, bs, gs = _ln_inputs(rng, 2, 37, 128, fs, with_bias)
    gs = [np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32)) for g in gs]
    with pltpu.force_tpu_interpret_mode():
        pallas = ld._pallas_ln_denses_bwd(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
            tuple(jnp.asarray(k) for k in ks), tuple(jnp.asarray(b) for b in bs),
            [jnp.asarray(g).astype(jnp.bfloat16) for g in gs], 1e-5, jnp.bfloat16, acts)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    dx, ds, db_, dws, dbs = tld._torch_ln_denses_bwd(
        torch.from_numpy(xb).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias), [torch.from_numpy(np.ascontiguousarray(k.T)) for k in ks],
        [torch.from_numpy(b) for b in bs], [torch.from_numpy(g).to(torch.bfloat16) for g in gs],
        1e-5, torch.bfloat16, list(acts))
    got = ([dx.float().numpy(), ds.numpy(), db_.numpy()], [w.numpy().T for w in dws],
           [d.numpy() for d in dbs])
    # the same roundings; a summation-order difference can flip one bf16 rounding of y or
    # gz (2^-8 relative), and dx takes one bf16 rounding on output
    _compare_ln(got, _split_jax(pallas, with_bias), rtol=1e-2, atol_rel=1e-2)


def test_act_grad_matches_jax(rng):
    z = np.concatenate([np.linspace(-40, 40, 4001), rng.standard_normal(4000) * 3])
    z = z.astype(np.float32)
    for act in ("gelu", "gelu_tanh", "quick_gelu"):
        want = np.asarray(ld._act_grad(jnp.asarray(z), act))
        got = tld._act_grad(torch.from_numpy(z), act).numpy()
        # the same fp32 formula in the same order; exp may differ by an ulp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_attention_autograd_gradcheck():
    """The autograd wrapper (plain path) against finite differences, float64."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 8, generator=g, dtype=torch.float64, requires_grad=True)
               for n in (5, 7, 7))
    assert torch.autograd.gradcheck(lambda a, b, c: tfa.fused_attention_mh(a, b, c, 2),
                                    (q, k, v))


@pytest.mark.parametrize("acts,with_bias", [
    (("gelu", None), (True, False)),
    (("gelu_tanh", "quick_gelu", None), (False, True, True)),
])
def test_ln_denses_autograd_gradcheck(acts, with_bias):
    """The autograd wrapper (plain path) against finite differences, float64: x, the LN
    affine, the weights and the biases, and a folded output scale (``w * s``, as the
    attention folds 1/sqrt(d) into wq) that the gradient reaches through."""
    g = torch.Generator().manual_seed(1)
    f64 = dict(dtype=torch.float64, generator=g)
    x = torch.randn(2, 3, 8, **f64).requires_grad_()
    scale = (1 + 0.2 * torch.randn(8, **f64)).requires_grad_()
    bias = (0.2 * torch.randn(8, **f64)).requires_grad_()
    ws = [(torch.randn(6, 8, **f64) / 3).requires_grad_() for _ in acts]
    bs = [(0.2 * torch.randn(6, **f64)).requires_grad_() if hb else None for hb in with_bias]
    live = [b for b in bs if b is not None]

    def f(x_, s_, b_, *params):
        w_ = list(params[:len(ws)])
        w_[0] = w_[0] * 0.5  # a folded constant output scale
        b_iter = iter(params[len(ws):])
        b_all = [next(b_iter) if hb else None for hb in with_bias]
        return tuple(tld.fused_ln_denses(x_, s_, b_, w_, b_all, 1e-5, torch.float64,
                                         list(acts)))

    assert torch.autograd.gradcheck(f, (x, scale, bias, *ws, *live))
