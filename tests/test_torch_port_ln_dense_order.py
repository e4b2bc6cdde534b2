"""The arithmetic order of K3's wide-row kernels (``pcdiff_torch/csrc/ln_dense.cu``,
namespace ``wide``: 256 < C <= 1024) against their plain version, on the CPU, at the Point-E
path's widths.

Each block normalises its rows once into a resident panel (128 or 64 rows in bf16, 64 or 32
in fp32): the statistics sum each row's x and x^2 in fp32, lane l of a warp over the
8-element chunks l, l + 32, ... in order, then across the 32 lanes by an xor butterfly;
mean = s / C, var = max(0, s2 / C - mean^2), rstd = rsqrt(var + eps); then
(x - mean) rstd scale + bias, rounded to the product dtype. bf16 outputs multiply on the
tensor cores with fp32 accumulation; fp32 outputs in 3xTF32 (each operand split into TF32
parts hi = rna(x), lo = rna(x - hi); per 8-deep step of C the products lo hi, hi lo, hi hi
added to the fp32 accumulator); bias and activation on the fp32 accumulator, one cast. This
file repeats that order in torch and holds it to ``ln_dense._torch_ln_denses`` within
``chip_smoke.py``'s ``LN_TOL``, at C = 512 (Point-E's qkv and fc1), 768 (the CLIP text
tower), 1024 (ViT-L/14) and a ragged 320 with ragged rows, for both dtypes; and shows that
the statistics taken by the exact variance instead of the fast formula stay within it, that
rows normalised without rstd do not, that rows left unrounded in bf16, which the limit cannot
see, more than double the mean error, and that fp32 products in 1xTF32 (the hi lo and lo hi
corrections dropped) exceed the fp32 limit. The emulation lives here only.
"""

import numpy as np
import pytest
import torch

from pcdiff_torch.ops import ln_dense as ld

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

LN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # chip_smoke.py
EPS = 1e-5
SITES = {  # name: (rows, C, outputs' F, activation)
    "Point-E qkv": (131, 512, (512, 512, 512), None),
    "Point-E fc1": (131, 512, (2048,), "gelu"),
    "CLIP text fc1": (77, 768, (3072,), "quick_gelu"),
    "ViT-L/14 qkv": (67, 1024, (1024, 1024, 1024), None),
    "ragged": (37, 320, (64, 192), "gelu_tanh"),
}


def _stats(x):
    """The statistics pass's (mean, rstd) of fp32 rows [R, C]."""
    r, c = x.shape
    chunks = c // 8
    lanes = torch.zeros(r, 32)
    lanes2 = torch.zeros(r, 32)
    for j in range(-(-chunks // 32)):
        for lane in range(32):
            ch = lane + 32 * j
            if ch >= chunks:
                continue
            for e in range(8):
                v = x[:, 8 * ch + e]
                lanes[:, lane] = lanes[:, lane] + v
                lanes2[:, lane] = lanes2[:, lane] + v * v
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes, lanes2 = lanes + lanes[:, idx ^ off], lanes2 + lanes2[:, idx ^ off]
    mean = lanes[:, :1] / c
    var = torch.clamp_min(lanes2[:, :1] / c - mean * mean, 0.0)
    return mean, torch.rsqrt(var + EPS)


def _tf32(x):
    """x rounded to TF32 as ``round_tf32`` (ptx.cuh) rounds it: to nearest, ties away from
    zero, the 13 low mantissa bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


TERMS = ("lo hi", "hi lo", "hi hi")  # 3xTF32's products, in the kernel's order


def _mm_3xtf32(a, b, terms=TERMS):
    """a @ b as the fp32 kernel's m16n8k8 TF32 products take it: per 8-deep step of the
    contraction, the products in ``terms`` added to the fp32 accumulator in that order."""
    parts = {}
    for name, t in (("a", a), ("b", b)):
        hi = _tf32(t)
        parts[name] = {"hi": hi, "lo": _tf32(t - hi)}
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for term in terms:
            x, y = term.split()
            acc = acc + parts["a"][x][..., k0:k0 + 8] @ parts["b"][y][..., k0:k0 + 8, :]
    return acc


def _panel(x, scale, bias, out, exact_var=False, round_y=True, use_rstd=True):
    """The normalised panel, once per row: fp32 statistics, the fp32 affine, rounded to the
    product dtype (bf16 outputs) or kept in fp32."""
    x32 = x.float()
    mean, rstd = _stats(x32)
    if exact_var:
        rstd = torch.rsqrt(((x32 - x32.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)
                           + EPS)
    y = (x32 - mean) * (rstd if use_rstd else 1.0) * scale + bias
    if out == torch.bfloat16 and round_y:
        y = y.bfloat16().float()
    return y


def _emulate_wide(x, scale, bias, ws, bs, out, acts, exact_var=False, round_y=True,
                  use_rstd=True, terms=TERMS):
    y = _panel(x, scale, bias, out, exact_var, round_y, use_rstd)
    outs = []
    for w, b, act in zip(ws, bs, acts):
        if out == torch.float32:
            o32 = _mm_3xtf32(y, w.t(), terms)
        else:
            o32 = y @ w.bfloat16().float().t()
        outs.append(ld._apply_act(o32 + b, act).to(out))
    return outs


def _inputs(rows, c, fs, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=g) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    ws = [torch.randn(f, c, generator=g) / c ** 0.5 for f in fs]
    bs = [0.1 * torch.randn(f, generator=g) for f in fs]
    return x, scale, bias, ws, bs


def _excess(got, ref, out):
    atol, rtol = LN_TOL[out]
    return max(((g.float() - r.float()).abs() - rtol * r.float().abs()).max().item() - atol
               for g, r in zip(got, ref))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", list(SITES))
def test_wide_order_within_card_tolerance(site, out):
    rows, c, fs, act = SITES[site]
    x, scale, bias, ws, bs = _inputs(rows, c, fs, seed=c + rows)
    if out == torch.bfloat16:
        x = x.bfloat16()
    acts = [act] * len(fs)
    ref = ld._torch_ln_denses(x, scale, bias, ws, bs, EPS, out, acts)
    got = _emulate_wide(x, scale, bias, ws, bs, out, acts)
    assert _excess(got, ref, out) <= 0, site
    assert _excess(_emulate_wide(x, scale, bias, ws, bs, out, acts, exact_var=True), ref,
                   out) <= 0


@pytest.mark.parametrize("fault", ["rows unrounded", "no rstd"])
def test_wide_tolerance_tells_a_wrong_order(fault):
    rows, c, fs, act = SITES["Point-E qkv"]
    x, scale, bias, ws, bs = _inputs(rows, c, fs, seed=7)
    x = x.bfloat16()
    ref = ld._torch_ln_denses(x, scale, bias, ws, bs, EPS, torch.bfloat16, [act] * 3)
    kw = {"rows unrounded": dict(round_y=False), "no rstd": dict(use_rstd=False)}[fault]
    got = _emulate_wide(x, scale, bias, ws, bs, torch.bfloat16, [act] * 3, **kw)
    if fault == "rows unrounded":  # within the max limit; a mean over the outputs shows it
        diff = np.mean([(g.float() - r.float()).abs().mean().item() for g, r in zip(got, ref)])
        same = np.mean([(g.float() - r.float()).abs().mean().item() for g, r in zip(
            _emulate_wide(x, scale, bias, ws, bs, torch.bfloat16, [act] * 3), ref)])
        assert diff > 2 * same
    else:
        assert _excess(got, ref, torch.bfloat16) > 0


@pytest.mark.parametrize("site", list(SITES))
def test_wide_fp32_tolerance_tells_1xtf32(site):
    """fp32 outputs in 1xTF32 (only hi hi: the corrections dropped) read past LN_TOL[fp32]
    at every site, where 3xTF32 keeps within it (test_wide_order_within_card_tolerance)."""
    rows, c, fs, act = SITES[site]
    x, scale, bias, ws, bs = _inputs(rows, c, fs, seed=c + rows)
    acts = [act] * len(fs)
    ref = ld._torch_ln_denses(x, scale, bias, ws, bs, EPS, torch.float32, acts)
    got = _emulate_wide(x, scale, bias, ws, bs, torch.float32, acts, terms=TERMS[2:])
    assert _excess(got, ref, torch.float32) > 0, site
