"""The arithmetic order of the whole-MLP kernel K5 (``pcdiff_torch/csrc/ln_mlp.cu``) against
its plain version, on the CPU, at the flagship's width (C = 256, F = 1024, O = 256) and at
Point-E's (the wide rows, below).

K5 normalises a block's rows once (fp32 fast-variance statistics, the fp32 affine) and
rounds them to the product dtype, then walks F in chunks of 64. Per chunk it forms fc1 with
fp32 accumulation over k steps (wgmma k16 steps in bf16; 32-deep FMA stages in fp32), adds
b1 and applies the activation on the fp32 accumulator, rounds h to the product dtype, and
accumulates h W2c^T into the fp32 output tile, which stays in registers over all the
chunks; at the end it adds b2 in fp32 and casts once. This file repeats that order in torch
(fp32 copies of the rounded operands; each step's fp32 sum taken by matmul, since the order
inside a tensor-core step is the hardware's) and holds it to ``_torch_ln_mlp`` within the
tolerances ``chip_smoke.py`` holds the kernel to on the card, for both dtypes and all four
activations: ``K5_TOL`` (fp32 1e-4, bf16 1e-2 of max |ref|) and, in bf16, ``K5_MEAN`` (1e-4 of
mean |ref|, mean absolute error). Readings of the sound order at these inputs: max 5.0e-7 to
6.7e-7 (fp32) and 1.5e-3 to 2.6e-3 (bf16) of max |ref|, mean 2.1e-6 to 4.3e-6 (bf16) of
mean |ref|.

Which faulty bf16 orders the limits tell apart: an order that keeps h in fp32 for fc2 (drops
h's rounding) and one that adds b2 after the cast (a second rounding) both read 4.9e-3 to
6.7e-3 of max |ref|, under K5_TOL: one bf16 ulp of the largest output is 2^-8 = 3.9e-3 of
max |ref|, so a max-error limit cannot see a single rounding. Their mean errors, 1.5e-3 to
1.6e-3 and 1.3e-3 to 1.4e-3 of mean |ref|, fail K5_MEAN by more than ten times, where the
sound order passes it by more than twenty. The ragged shape (C = 96, F = 192, O = 160) shows
that the kernel's zero fill (the panel and W1 past C, W2's rows past O) leaves the sums
unchanged.

The wide rows (Point-E's MLP, C = O = 512, F = 2048; 67 rows, a ragged 64-row tile) split O
between the consumers and form each chunk's h once, shared through shared memory; bf16
products are wgmma k16 steps, fp32 ones 3xTF32 on mma.sync k8 steps (each operand split into
TF32 parts hi = rna(x), lo = rna(x - hi); lo hi, hi lo, hi hi), and a cluster's two blocks
sum half of F's chunks each, added in fp32. Readings of that order (exact GELU): fp32 8.7e-7
to 1.1e-6 of max |ref|; bf16 2.4e-3 to 2.6e-3 of max |ref|, mean 5.2e-6 to 1.1e-5 of mean
|ref|. Rejected: fp32 products in 1xTF32 (4.1e-4 of max |ref|, over K5_TOL), bf16 with h
kept in fp32 (mean 1.6e-3, over K5_MEAN). The emulation lives here only; nothing on the
port's path calls it.
"""

import math

import numpy as np
import pytest
import torch

from pcdiff_torch.ops import ln_dense as ld
from pcdiff_torch.ops import ln_mlp as lm

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

ROWS, C, F, O, FC = 320, 256, 1024, 256, 64
EPS = 1e-5
# chip_smoke.py: K5 against its plain version, of max |ref|; in bf16 also the mean error
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K5_MEAN = 1e-4  # of mean |ref|
ACTS = [None, "gelu", "gelu_tanh", "quick_gelu"]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(dtype, seed, c=C, f=F, o=O, rows=ROWS):
    """chip_smoke._mlp_inputs' distribution, from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift)

    x = t(rows, c, scale=2.0, shift=0.5).to(dtype)
    return (x, t(c, scale=0.2, shift=1.0), t(c, scale=0.2), t(f, c, scale=1 / math.sqrt(c)),
            t(f, scale=0.2), t(o, f, scale=1 / math.sqrt(f)), t(o, scale=0.2))


def _emulate_k5(x, scale, bias, w1, b1, w2, b2, dtype, act, round_h=True,
                b2_after_cast=False, pad=False):
    """K5's order: y rounded to the product dtype, fc1 per 64-wide chunk of F accumulated in
    fp32 over k steps, b1 and the activation in fp32, h rounded, fc2 accumulated chunk by
    chunk into the fp32 output tile, b2 added, one cast. With ``pad``, y and W1 are zero past
    C up to 256 and W2 zero past O up to 256, as the kernel's panel and ring hold them."""
    mxu = ld._product_dtype(dtype)
    step = 16 if dtype == torch.bfloat16 else 32  # a wgmma k16 step; a 32-deep FMA stage
    y = ld._normalise(x, scale, bias, EPS, torch.float32)[2].to(mxu).float()
    w1m, w2m = w1.to(mxu).float(), w2.to(mxu).float()
    c, (o, f) = y.shape[-1], w2.shape
    if pad:
        y = torch.nn.functional.pad(y, (0, 256 - c))
        w1m = torch.nn.functional.pad(w1m, (0, 256 - c))
        w2m = torch.nn.functional.pad(w2m, (0, 0, 0, 256 - o))
    acc2 = torch.zeros(y.shape[0], w2m.shape[0])
    for f0 in range(0, f, FC):
        acc1 = torch.zeros(y.shape[0], FC)
        for k0 in range(0, y.shape[-1], step):
            acc1 = acc1 + y[:, k0:k0 + step] @ w1m[f0:f0 + FC, k0:k0 + step].t()
        h = ld._apply_act(acc1 + b1[f0:f0 + FC], act)
        if round_h:
            h = h.to(mxu).float()
        for k0 in range(0, FC, step):
            acc2 = acc2 + h[:, k0:k0 + step] @ w2m[:, f0 + k0:f0 + k0 + step].t()
    acc2 = acc2[:, :o]
    if b2_after_cast:
        return (acc2.to(dtype).float() + b2).to(dtype)
    return (acc2 + b2).to(dtype)


def _errors(got, ref):
    """(max |err| over max |ref|, mean |err| over mean |ref|)."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    return (d.max() / r.max()).item(), (d.mean() / r.mean()).item()


@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k5_order_within_card_tolerance(dtype, act):
    args = _inputs(dtype, seed=ACTS.index(act))
    ref = lm._torch_ln_mlp(*args, EPS, dtype, act)
    got = _emulate_k5(*args, dtype, act)
    assert got.shape == ref.shape == (ROWS, O) and got.dtype == dtype
    max_rel, mean_rel = _errors(got, ref)
    assert max_rel <= K5_TOL[dtype], f"{dtype} {act}: {max_rel:.3e} of max |ref|"
    if dtype == torch.bfloat16:
        assert mean_rel <= K5_MEAN, f"{act}: mean {mean_rel:.3e} of mean |ref|"


WRONG_ORDERS = {"h unrounded": dict(round_h=False), "b2 after the cast": dict(b2_after_cast=True)}


@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("order", list(WRONG_ORDERS))
def test_k5_bf16_limits_against_wrong_orders(order, act):
    """A single bf16 rounding dropped or added passes the max-error limit and fails the
    mean-error one."""
    args = _inputs(torch.bfloat16, seed=10 + ACTS.index(act))
    ref = lm._torch_ln_mlp(*args, EPS, torch.bfloat16, act)
    max_rel, mean_rel = _errors(_emulate_k5(*args, torch.bfloat16, act, **WRONG_ORDERS[order]),
                                ref)
    assert max_rel <= K5_TOL[torch.bfloat16], f"{order} {act}: {max_rel:.3e} of max |ref|"
    assert mean_rel > 10 * K5_MEAN, f"{order} {act}: mean {mean_rel:.3e} of mean |ref|"


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k5_zero_fill_at_a_ragged_shape(dtype):
    """C % 64 == 32 and O < 256 (chip_smoke's second off-path shape): the kernel's zeros
    past C and past O change no sum, and the order stays within the card's tolerance."""
    args = _inputs(dtype, seed=20, c=96, f=192, o=160)
    padded = _emulate_k5(*args, dtype, "gelu", pad=True)
    assert torch.equal(padded, _emulate_k5(*args, dtype, "gelu"))
    max_rel, mean_rel = _errors(padded, lm._torch_ln_mlp(*args, EPS, dtype, "gelu"))
    assert max_rel <= K5_TOL[dtype]
    if dtype == torch.bfloat16:
        assert mean_rel <= K5_MEAN


# ---- the wide rows: Point-E's MLP (C = O = 512, F = 2048) ----

WIDE_ROWS, WC, WF = 67, 512, 2048  # a ragged row tile: the wide rows take 64 a block


def _tf32(x):
    """x rounded to TF32 as the kernel's round_tf32: to nearest, ties away from zero, the 13
    low bits of fp32's layout zero."""
    b = (x.contiguous().view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _steps(a, b, lo, hi, step, terms):
    """sum over k in [lo, hi) of a[:, k] b[:, k]^T, one fp32 sum a k step as the kernel's
    products take them: bf16 wgmma k16 steps (a, b the rounded operands), or 3xTF32 mma.sync
    k8 steps (a, b their (hi, lo) TF32 parts: lo hi, hi lo, hi hi, in that order; with
    terms = 1 hi hi only, 1xTF32)."""
    if not isinstance(a, tuple):
        out = torch.zeros(a.shape[0], b.shape[0])
        for k0 in range(lo, hi, step):
            out = out + a[:, k0:k0 + step] @ b[:, k0:k0 + step].t()
        return out
    (ahi, alo), (bhi, blo) = a, b
    out = torch.zeros(ahi.shape[0], bhi.shape[0])
    for k0 in range(lo, hi, step):
        k = slice(k0, k0 + step)
        if terms == 3:
            out = out + alo[:, k] @ bhi[:, k].t()
            out = out + ahi[:, k] @ blo[:, k].t()
        out = out + ahi[:, k] @ bhi[:, k].t()
    return out


_ERF_P = (0.0034082910107109506, 0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_Q = (0.000023547966471313185, 0.0010179625278914885, 0.014070470171167667,
          0.11098505178285362, 0.49746925110067538, 1.0)


def _gelu_fma(v):
    """The wide rows' exact GELU (``ln_mlp.cu`` ``gelu_fma``): XLA's erf rational with
    its Horner steps fused (each multiply-add rounded once, as ``fmaf``), the quotient taken
    as one fp32 division (the kernel's ``__fdividef`` is within two ulps of it)."""
    def fma(a, b, c):
        return (a.double() * b.double() + c).float()

    x = (v * 0.70710678118654752).clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x2, 0.00022905065861350646)
    for c in _ERF_P:
        p = fma(p, x2, c)
    q = torch.full_like(x2, -1.1791602954361697e-7)
    for c in _ERF_Q:
        q = fma(q, x2, c)
    half = 0.5 * v
    return fma(half, (x * p) / q, half)


def _emulate_wide(x, scale, bias, w1, b1, w2, b2, dtype, act, splits=1, round_h=True, terms=3):
    """The wide rows' order: y rounded to the product dtype; fc1 per k step (the F chunks
    change no element's sum); b1 and the activation in fp32 (the exact GELU on FMAs,
    :func:`_gelu_fma`); h rounded; fc2 per O half (256
    columns: a warpgroup's or four warps' share), its k steps over F in order, in ``splits``
    partial tiles (a cluster's two blocks, each half of F's chunks) added in fp32; b2, one
    cast. fp32 products in 3xTF32."""
    mxu = ld._product_dtype(dtype)
    y = ld._normalise(x, scale, bias, EPS, torch.float32)[2].to(mxu).float()
    w1m, w2m = w1.to(mxu).float(), w2.to(mxu).float()
    fp32 = dtype == torch.float32
    step = 8 if fp32 else 16
    ops = _split if fp32 else (lambda t: t)
    acc1 = _steps(ops(y), ops(w1m), 0, y.shape[1], step, terms)
    h = _gelu_fma(acc1 + b1) if act == "gelu" else ld._apply_act(acc1 + b1, act)
    if round_h:
        h = h.to(mxu).float()
    f = h.shape[1]
    bounds = [f // 64 * i // splits * 64 for i in range(splits + 1)]
    halves = []
    for o0 in range(0, w2m.shape[0], 256):
        parts = [_steps(ops(h), ops(w2m[o0:o0 + 256]), lo, hi, step, terms)
                 for lo, hi in zip(bounds, bounds[1:])]
        halves.append(parts[0] if splits == 1 else parts[0] + parts[1])
    return (torch.cat(halves, dim=1) + b2).to(dtype)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k5_wide_order_within_card_tolerance(dtype, splits):
    """The wide rows' order at Point-E's MLP (exact GELU), one block or a cluster's two, within
    the card's limits."""
    args = _inputs(dtype, seed=30 + splits, c=WC, f=WF, o=WC, rows=WIDE_ROWS)
    ref = lm._torch_ln_mlp(*args, EPS, dtype, "gelu")
    got = _emulate_wide(*args, dtype, "gelu", splits=splits)
    assert got.shape == ref.shape == (WIDE_ROWS, WC) and got.dtype == dtype
    max_rel, mean_rel = _errors(got, ref)
    assert max_rel <= K5_TOL[dtype], f"{dtype}: {max_rel:.3e} of max |ref|"
    if dtype == torch.bfloat16:
        assert mean_rel <= K5_MEAN, f"mean {mean_rel:.3e} of mean |ref|"


def test_k5_wide_limits_reject_wrong_orders():
    """fp32 products in 1xTF32 fail K5_TOL; in bf16, h kept in fp32 passes the max-error limit
    and fails the mean-error one."""
    args = _inputs(torch.float32, seed=40, c=WC, f=WF, o=WC, rows=WIDE_ROWS)
    ref = lm._torch_ln_mlp(*args, EPS, torch.float32, "gelu")
    max_rel, _ = _errors(_emulate_wide(*args, torch.float32, "gelu", terms=1), ref)
    assert max_rel > K5_TOL[torch.float32], f"1xTF32: {max_rel:.3e} of max |ref|"
    args = _inputs(torch.bfloat16, seed=41, c=WC, f=WF, o=WC, rows=WIDE_ROWS)
    ref = lm._torch_ln_mlp(*args, EPS, torch.bfloat16, "gelu")
    max_rel, mean_rel = _errors(_emulate_wide(*args, torch.bfloat16, "gelu", round_h=False), ref)
    assert max_rel <= K5_TOL[torch.bfloat16], f"h unrounded: {max_rel:.3e} of max |ref|"
    assert mean_rel > 10 * K5_MEAN, f"h unrounded: mean {mean_rel:.3e} of mean |ref|"
