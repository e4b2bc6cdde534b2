"""The arithmetic order of the whole-MLP kernel K5 (``pcdiff_torch/csrc/ln_mlp.cu``) against
its plain version, on the CPU, at the flagship's width (C = 256, F = 1024, O = 256).

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
unchanged. The emulation lives here only; nothing on the port's path calls it.
"""

import math

import numpy as np
import pytest
import torch

from pcdiff_torch.ops import ln_dense as ld
from pcdiff_torch.ops import ln_mlp as lm

torch.set_num_threads(2)

ROWS, C, F, O, FC = 320, 256, 1024, 256, 64
EPS = 1e-5
# chip_smoke.py: K5 against its plain version, of max |ref|; in bf16 also the mean error
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K5_MEAN = 1e-4  # of mean |ref|
ACTS = [None, "gelu", "gelu_tanh", "quick_gelu"]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(dtype, seed, c=C, f=F, o=O):
    """chip_smoke._mlp_inputs' distribution, from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift)

    x = t(ROWS, c, scale=2.0, shift=0.5).to(dtype)
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
