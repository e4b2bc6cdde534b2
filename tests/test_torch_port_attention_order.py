"""The arithmetic order of the bf16 attention loop (``pcdiff_torch/csrc/attention_fwd.cuh``)
against the plain versions, on the CPU, at the flagship's width.

The loop that K1 and K7 share walks the keys in tiles of 64 with an online row max, takes
its exponentials as ``exp2`` of log2e-scaled scores (one fused multiply-add, one rounding),
and rounds where its numerics class says: K1 rounds the unnormalised P to bf16 against the
running max and divides by the fp32 row sum after PV; K7 takes a first sweep for the row max
and sum and then rounds ``exp2(s log2e - (m log2e + log2 l))``, the normalised weight, to
bf16. K1's bf16 exp mode rounds bf16(s - m) and its exp2 to bf16 against the final row max,
as the TPU kernel's exp panel does: in one pass where ``fa._exp_plan`` splits the panel's
keys over the warps of a block (each warp's slice max, the final max from them, partial sums
and outputs per slice added in warp order), else after a first sweep for the max alone (K7's
first sweep without the sum). K7's fp32 kernel makes one pass instead (in fp32 the rounding of
the normalised weights does nothing): the online max and sum of K1, each product in 3xTF32
(operands split into TF32 parts hi = rna(x), lo = rna(x - hi); per 8-deep step lo hi, then
hi lo, then hi hi into the fp32 accumulator) and one division by the row sum at the end.
This file repeats those
orders in torch and holds them to ``_torch_attention_mh(..., mxu_dtype=bf16[, exp_dtype=
bf16])`` and ``_torch_attention`` within the tolerances ``chip_smoke.py`` holds the kernels
to on the card (``ATTN_ATOL``, ``K7_TOL``), with bf16 inputs (K7 fp32: fp32 inputs) at 8 heads of 32,
two rows, the backbone's z, read and write sites and the ragged point-cloud encoder, and K1's
two orders at head dim 64 at the Point-E path's vision, base40M and textvec panels (the
default mode's in 128-key tiles, ``attention_mh64.cu``'s); it
shows that K7's fp32 tolerance fails an order that drops one of 3xTF32's correction terms
(in S or in PV) or all of them (1xTF32), and holds the fp32 order to the TPU kernel in
interpret mode at a ragged head-dim-64 shape. With
fp32 inputs it also holds the bf16 exp mode's order to the mean limit ``chip_smoke.py`` adds
there (``ATTN_EXP_MEAN``), and shows that the limit fails an order that drops either of the
mode's two roundings, or K1's default mode. The emulation lives here only; nothing on the
port's path calls it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff.ops import flash_attention as jfa
from pcdiff_torch.ops import flash_attention as fa

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

HEADS, D, ROWS, TILE = 8, 32, 2, 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ATTN_ATOL = 2e-2  # chip_smoke.py: K1 against its plain version
K7_TOL_BF16 = 2e-2  # chip_smoke.py: K7 against its plain version, bf16
K7_TOL_FP32 = 1e-4  # chip_smoke.py: K7 against its plain version, fp32
ATTN_EXP_MEAN = 1e-5  # chip_smoke.py: K1's bf16 exp mode, mean abs error with fp32 inputs
SHAPES = {  # (Nq, Nk): the backbone's sites and the point-cloud encoder (ragged both ways)
    "z": (643, 643),
    "read": (643, 1024),
    "write": (1024, 643),
    "ppcd encoder": (1025, 1025),
}


def _exp2_fma(s, off):
    """exp2(fma(s, log2e, -off)) in fp32: the product and the difference rounded once."""
    return torch.exp2((s.double() * LOG2E.double() - off.double()).float())


def _online_stats(q, k):
    """The online row max and row sum over 64-key tiles, as the loop keeps them."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    for k0 in range(0, k.shape[-2], TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        l = l * alpha + _exp2_fma(s, m_new * LOG2E).sum(-1, keepdim=True)
        m = m_new
    return m, l


def _emulate_k1(q, k, v, tile=TILE):
    """K1's order on [B, H, N, D] fp32 copies of bf16 operands: P rounded to bf16 against the
    running max, the output rescaled by alpha, divided by the fp32 row sum after PV; keys in
    tiles of ``tile`` (64 in the shared loop, 128 in the head-dim-64 kernel)."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], tile):
        s = q @ k[..., k0:k0 + tile, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = _exp2_fma(s, m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ v[..., k0:k0 + tile, :]
        m = m_new
    return o * (1.0 / l)


def _emulate_k7(q, k, v):
    """K7's order: the row max and sum from a first sweep, then the normalised weights
    exp2(s log2e - (m log2e + log2 l)) rounded to bf16 and multiplied by V in fp32."""
    m, l = _online_stats(q, k)
    c = (m.double() * LOG2E.double() + torch.log2(l).double()).float()
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        o = o + _exp2_fma(s, c).bfloat16().float() @ v[..., k0:k0 + TILE, :]
    return o


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties away from zero,
    the 13 low mantissa bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


TERMS = ("lo hi", "hi lo", "hi hi")  # 3xTF32's products, in the kernel's order


def _mm_3xtf32(a, b, terms=TERMS):
    """a @ b as the kernel's m16n8k8 TF32 products take it: each operand split into
    hi = rna(x) and lo = rna(x - hi), and per 8-deep step of the contraction the products in
    ``terms`` (lo hi, hi lo, hi hi) added to the fp32 accumulator in that order."""
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


def _emulate_k7_fp32(q, k, v, s_terms=TERMS, pv_terms=TERMS):
    """K7's fp32 order: one pass over 64-key tiles, S = Q K^T in 3xTF32, the online row max
    and sum (exp2 of log2e-scaled scores, O rescaled by exp2 of the max's change), O += P V
    in 3xTF32 with P unnormalised, and O divided by the fp32 row sum once at the end.
    ``s_terms`` / ``pv_terms`` short of ``TERMS`` drop products (a faulty kernel)."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = _mm_3xtf32(q, k[..., k0:k0 + TILE, :].transpose(-1, -2), s_terms)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = _exp2_fma(s, m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm_3xtf32(p, v[..., k0:k0 + TILE, :], pv_terms)
        m = m_new
    return o / l


def _emulate_k1_bf16_exp(q, k, v, round_t=True, round_p=True):
    """K1's bf16 exp mode (BF16_EXP): the final row max from a first sweep over K (the
    QK_MAX cut), then per 64-key tile t = bf16(s - m), p = bf16(exp2(t log2e)) with the
    product rounded to fp32 once, the rounded p summed in fp32 and multiplied by V in fp32,
    and the output divided by the fp32 row sum after PV. ``round_t`` / ``round_p`` False
    drop a rounding (a faulty kernel, for the mean limit's test)."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    for k0 in range(0, k.shape[-2], TILE):
        m = torch.maximum(m, (q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)).amax(-1, True))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        t = (s - m).bfloat16().float() if round_t else s - m
        p = torch.exp2(t * LOG2E)
        p = p.bfloat16().float() if round_p else p
        l = l + p.sum(-1, keepdim=True)
        o = o + p @ v[..., k0:k0 + TILE, :]
    return o * (1.0 / l)


def _slices(nk, plan):
    """The key ranges of a one-pass plan (splits, slice): warp w's [w slice, ...), in order."""
    splits, size = plan
    return [(w * size, min((w + 1) * size, nk)) for w in range(splits)]


def _emulate_k1_bf16_exp_split(q, k, v, plan):
    """K1's bf16 exp mode in one pass (``exp_block``): each warp's S over its slice of the
    keys and the slice's row max; the final max, the max of the slice maxes; per slice
    t = bf16(s - m), p = bf16(exp2(t log2e)), a partial fp32 sum of the rounded p and a
    partial O = p V in fp32; the partials added in warp order, then O divided by the sum
    after PV."""
    ranges = _slices(k.shape[-2], plan)
    s = [q @ k[..., a:b, :].transpose(-1, -2) for a, b in ranges]
    m = torch.stack([t.amax(-1, keepdim=True) for t in s]).amax(0)
    o, l = 0.0, 0.0
    for t, (a, b) in zip(s, ranges):
        p = torch.exp2((t - m).bfloat16().float() * LOG2E).bfloat16().float()
        l = l + p.sum(-1, keepdim=True)
        o = o + p @ v[..., a:b, :]
    return o * (1.0 / l)


def _emulate_k1_bf16_exp_one_pass(q, k, v):
    """The one-pass order at the plan the wrapper gives the panel."""
    return _emulate_k1_bf16_exp_split(q, k, v, fa._exp_plan(k.shape[-2]))


def _inputs(nq, nk, seed, dtype=torch.bfloat16):
    """chip_smoke.py's inputs: q scaled as a pre-scaled query, k and v standard normal."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((ROWS, nq, HEADS * D), dtype=np.float32) * (2 / math.sqrt(D))
    k = rng.standard_normal((ROWS, nk, HEADS * D), dtype=np.float32)
    v = rng.standard_normal((ROWS, nk, HEADS * D), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def _split(t):
    """[B, N, H*D] -> [B, H, N, D] in fp32."""
    b, n, _ = t.shape
    return t.float().reshape(b, n, HEADS, D).transpose(1, 2)


K1_ORDERS = {"K1": _emulate_k1, "K1 bf16 exp": _emulate_k1_bf16_exp,
             "K1 bf16 exp one pass": _emulate_k1_bf16_exp_one_pass}


def _heads(*ts):
    """[B, N, H*D] -> the [B, H, N, D] views K7 takes, in their dtype."""
    return tuple(t.reshape(ROWS, t.shape[1], HEADS, D).transpose(1, 2) for t in ts)


@pytest.mark.parametrize("kernel", ["K1", "K7", "K1 bf16 exp", "K1 bf16 exp one pass",
                                    "K7 fp32"])
@pytest.mark.parametrize("site", list(SHAPES))
def test_loop_order_within_card_tolerance(site, kernel):
    nq, nk = SHAPES[site]
    dtype = torch.float32 if kernel == "K7 fp32" else torch.bfloat16
    q, k, v = _inputs(nq, nk, seed=list(SHAPES).index(site), dtype=dtype)
    if kernel == "K7 fp32":
        qs, ks, vs = _heads(q, k, v)
        ref = fa._torch_attention(qs, ks, vs)
        got = _emulate_k7_fp32(qs, ks, vs)
        tol = K7_TOL_FP32
    elif kernel.startswith("K1"):
        exp = torch.float32 if kernel == "K1" else torch.bfloat16
        emulate = K1_ORDERS[kernel]
        ref = fa._torch_attention_mh(q, k, v, HEADS, mxu_dtype=torch.bfloat16,
                                     exp_dtype=exp).float()
        got = emulate(*(_split(t) for t in (q, k, v)))
        got = fa._fold(got, q).float()  # the kernel's output in q's dtype, bf16
        tol = ATTN_ATOL
    else:
        qs, ks, vs = _heads(q, k, v)
        ref = fa._torch_attention(qs, ks, vs).float()
        got = _emulate_k7(*(t.float() for t in (qs, ks, vs))).bfloat16().float()
        tol = K7_TOL_BF16
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= tol, f"{kernel} {site}: max abs error {err:.3e} > {tol:g}"


# K1 at head dim 64, the Point-E path's: (rows, Nq, Nk, heads) of the ViT-L/14 tower, base40M
# (CFG's 2B rows) and base40M-textvec; both modes run csrc/attention_mh64.cu, whose key tiles
# are 128 wide
SHAPES_D64 = {"vision": (1, 257, 257, 16), "base40M": (2, 1281, 1281, 8),
              "textvec": (1, 1026, 1026, 8)}
K1_TILE_D64 = 128  # attention_mh64.cu's BKV


def _emulate_k1_split(q, k, v, splits, tile=K1_TILE_D64):
    """K1's order at head dim 64 with a query tile's keys split over ``splits`` blocks (a
    cluster): block r takes key tiles [n r / splits, n (r + 1) / splits) of the n tiles and
    keeps K1's online order on them (O unnormalised, its running max m_r and its row sum
    l_r); rank 0 then takes the others' in rank order, m = max(m, m_r), the scales
    2^((m_old - m) log2e) and 2^((m_r - m) log2e) (each product rounded once) on O and l, and
    divides by the fp32 sum at the end."""
    ntiles = -(-k.shape[-2] // tile)
    parts = []
    for r in range(splits):
        a, b = tile * (ntiles * r // splits), min(k.shape[-2], tile * (ntiles * (r + 1) // splits))
        m = torch.full(q.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape)
        for k0 in range(a, b, tile):
            s = q @ k[..., k0:min(k0 + tile, b), :].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = _exp2_fma(s, m_new * LOG2E)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + p.bfloat16().float() @ v[..., k0:min(k0 + tile, b), :]
            m = m_new
        parts.append((o, m, l))
    o, m, l = parts[0]
    for o_r, m_r, l_r in parts[1:]:
        mn = torch.maximum(m, m_r)
        sa, sb = torch.exp2((m - mn) * LOG2E), torch.exp2((m_r - mn) * LOG2E)
        o, l, m = o * sa + o_r * sb, l * sa + l_r * sb, mn
    return o * (1.0 / l)


def _ranks(nk, splits, tile=K1_TILE_D64):
    """The key ranges [a, b) of a cluster's blocks, in rank order: block r takes key tiles
    [n r / splits, n (r + 1) / splits) of the panel's n tiles."""
    ntiles = -(-nk // tile)
    return [(tile * (ntiles * r // splits), min(nk, tile * (ntiles * (r + 1) // splits)))
            for r in range(splits)]


def _emulate_k1_bf16_exp_64(q, k, v, splits=1, round_t=True, round_p=True,
                            tile=K1_TILE_D64):
    """K1's bf16 exp mode at head dim 64 (``attention_mh64.cu``'s EXP instantiation): each
    block of the cluster sweeps its key tiles once for S and the row max alone; the blocks
    trade their maxes, so each takes the panel's final max; then each sweeps its tiles again,
    t = bf16(s - m), p = bf16(exp2(t log2e)) with the product rounded to fp32 once, a partial
    fp32 sum of the rounded p and a partial O = p V, with no rescale; rank 0 adds the
    partials in rank order and divides by the sum after PV. ``round_t`` / ``round_p`` False
    drop a rounding (a faulty kernel, for the mean limit's test)."""
    ranges = _ranks(k.shape[-2], splits, tile)
    maxes = []
    for a, b in ranges:
        m_r = torch.full(q.shape[:-1] + (1,), -math.inf)
        for k0 in range(a, b, tile):
            s = q @ k[..., k0:min(k0 + tile, b), :].transpose(-1, -2)
            m_r = torch.maximum(m_r, s.amax(-1, keepdim=True))
        maxes.append(m_r)
    m = torch.stack(maxes).amax(0)  # the trade: every rank's max
    o, l = 0.0, 0.0
    for a, b in ranges:
        o_r = torch.zeros(q.shape)
        l_r = torch.zeros(q.shape[:-1] + (1,))
        for k0 in range(a, b, tile):
            s = q @ k[..., k0:min(k0 + tile, b), :].transpose(-1, -2)
            t = (s - m).bfloat16().float() if round_t else s - m
            p = torch.exp2(t * LOG2E)
            p = p.bfloat16().float() if round_p else p
            l_r = l_r + p.sum(-1, keepdim=True)
            o_r = o_r + p @ v[..., k0:min(k0 + tile, b), :]
        o, l = o + o_r, l + l_r
    return o * (1.0 / l)


K1_ORDERS_D64 = {"K1": lambda q, k, v: _emulate_k1(q, k, v, tile=K1_TILE_D64),
                 "K1 bf16 exp": _emulate_k1_bf16_exp_64,
                 "K1 2 splits": lambda q, k, v: _emulate_k1_split(q, k, v, 2),
                 "K1 3 splits": lambda q, k, v: _emulate_k1_split(q, k, v, 3),
                 "K1 bf16 exp 2 splits": lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, 2),
                 "K1 bf16 exp 3 splits": lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, 3),
                 "K1 bf16 exp 4 splits": lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, 4)}


@pytest.mark.parametrize("kernel", list(K1_ORDERS_D64))
@pytest.mark.parametrize("site", list(SHAPES_D64))
def test_k1_order_at_head_dim_64_within_card_tolerance(site, kernel):
    rows, nq, nk, heads = SHAPES_D64[site]
    assert fa._exp_plan(nk, 64) is None  # no one-pass plan at D = 64
    rng = np.random.default_rng(nq + heads)
    q = torch.from_numpy(rng.standard_normal((rows, nq, heads * 64), dtype=np.float32)
                         * (2 / math.sqrt(64))).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((rows, nk, heads * 64), dtype=np.float32)
                             ).bfloat16() for _ in range(2))
    exp = torch.bfloat16 if kernel.startswith("K1 bf16 exp") else torch.float32
    ref = fa._torch_attention_mh(q, k, v, heads, mxu_dtype=torch.bfloat16,
                                 exp_dtype=exp).float()
    split = (t.float().reshape(rows, t.shape[1], heads, 64).transpose(1, 2) for t in (q, k, v))
    got = fa._fold(K1_ORDERS_D64[kernel](*split), q).float()
    err = (got - ref).abs().max().item()
    assert err <= ATTN_ATOL, f"{kernel} {site} (D = 64): max abs error {err:.3e}"


K7_FP32_FAULTS = {  # name: (S's products, PV's products)
    "S without lo hi": (TERMS[1:], TERMS),
    "PV without lo hi": (TERMS, TERMS[1:]),
    "1xTF32": (TERMS[2:], TERMS[2:]),
}


@pytest.mark.parametrize("fault", list(K7_FP32_FAULTS))
@pytest.mark.parametrize("site", ["z", "write"])
def test_k7_fp32_tolerance_tells_a_dropped_term(site, fault):
    """K7_TOL[fp32] (1e-4) sees 3xTF32 short of a correction term: one S product dropped
    reads ~1.0e-3 to ~1.2e-3 here, one PV product ~2.1e-4 to ~2.2e-4, 1xTF32 ~2.0e-3 to
    ~2.1e-3, where the kernel's order reads ~2.6e-6 to ~3.1e-6 at the four sites
    (test_loop_order_within_card_tolerance)."""
    nq, nk = SHAPES[site]
    q, k, v = _heads(*_inputs(nq, nk, seed=list(SHAPES).index(site), dtype=torch.float32))
    s_terms, pv_terms = K7_FP32_FAULTS[fault]
    err = (_emulate_k7_fp32(q, k, v, s_terms, pv_terms) - fa._torch_attention(q, k, v))
    err = err.abs().max().item()
    assert err > K7_TOL_FP32, f"{fault} {site}: max abs error {err:.3e}"


def test_k7_fp32_order_matches_the_tpu_kernel():
    """The one-pass 3xTF32 order against the TPU kernel in interpret mode, off the main path:
    head dim 64, ragged query and key counts (not multiples of 16 or 64)."""
    rng = np.random.default_rng(64)
    q = rng.standard_normal((2, 2, 37, 64), dtype=np.float32) * (2 / math.sqrt(64))
    k, v = (rng.standard_normal((2, 2, 53, 64), dtype=np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._pallas_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = _emulate_k7_fp32(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= K7_TOL_FP32, f"max abs error {err:.3e}"


VARIANTS = {  # name: (the order, whether it is the mode's)
    "bf16 exp": (_emulate_k1_bf16_exp, True),
    "bf16 exp one pass": (_emulate_k1_bf16_exp_one_pass, True),
    "s - m not rounded": (lambda q, k, v: _emulate_k1_bf16_exp(q, k, v, round_t=False), False),
    "exp not rounded": (lambda q, k, v: _emulate_k1_bf16_exp(q, k, v, round_p=False), False),
    "default mode": (_emulate_k1, False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("site", list(SHAPES))
def test_bf16_exp_mean_limit_tells_the_roundings(site, variant):
    """fp32 inputs, as phase 15 of chip_smoke.py reads them: the mode's orders (two sweeps,
    and one pass over the plan's slices) keep their mean error against the plain version
    under ATTN_EXP_MEAN (~3.5e-8 here, where both sum the scores alike), and an order
    without one of its roundings, or K1's default mode, reads above it (~1.3e-4 to
    ~3.1e-4)."""
    nq, nk = SHAPES[site]
    q, k, v = _inputs(nq, nk, seed=list(SHAPES).index(site), dtype=torch.float32)
    ref = fa._torch_attention_mh(q, k, v, HEADS, mxu_dtype=torch.bfloat16,
                                 exp_dtype=torch.bfloat16)
    emulate, sound = VARIANTS[variant]
    got = fa._fold(emulate(*(_split(t.bfloat16()) for t in (q, k, v))), q)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    mean = (got - ref).abs().mean().item()
    assert (mean <= ATTN_EXP_MEAN) is sound, f"{variant} {site}: mean abs error {mean:.3e}"


VARIANTS_D64 = {  # name: (the order, whether it is the mode's)
    "bf16 exp": (_emulate_k1_bf16_exp_64, True),
    "bf16 exp 4 splits": (lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, 4), True),
    "s - m not rounded": (lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, round_t=False),
                          False),
    "exp not rounded": (lambda q, k, v: _emulate_k1_bf16_exp_64(q, k, v, round_p=False),
                        False),
    "default mode": (lambda q, k, v: _emulate_k1(q, k, v, tile=K1_TILE_D64), False),
}


@pytest.mark.parametrize("variant", list(VARIANTS_D64))
def test_bf16_exp_mean_limit_tells_the_roundings_at_head_dim_64(variant):
    """fp32 inputs at the textvec panel, as phase 20 of chip_smoke.py reads the head-dim-64
    exp mode: its order, unsplit and over a cluster of 4, keeps its mean error against the
    plain version under ATTN_EXP_MEAN, and an order without one of its roundings, or K1's
    default mode (phase 20's control), reads above it."""
    rows, nq, nk, heads = SHAPES_D64["textvec"]
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((rows, nq, heads * 64), dtype=np.float32)
                         * (2 / math.sqrt(64)))
    k, v = (torch.from_numpy(rng.standard_normal((rows, nk, heads * 64), dtype=np.float32))
            for _ in range(2))
    ref = fa._torch_attention_mh(q, k, v, heads, mxu_dtype=torch.bfloat16,
                                 exp_dtype=torch.bfloat16)
    emulate, sound = VARIANTS_D64[variant]
    split = (t.bfloat16().float().reshape(rows, t.shape[1], heads, 64).transpose(1, 2)
             for t in (q, k, v))
    got = fa._fold(emulate(*split), q)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    mean = (got - ref).abs().mean().item()
    assert (mean <= ATTN_EXP_MEAN) is sound, f"{variant} (D = 64): mean abs error {mean:.3e}"


# Every key count the paths give K1 (the backbone's 643 and 1024, the encoders' 1025, 257, 256,
# 255 and 127), the one-pass plans' capacity (1152 keys) and one key past it
PLAN_NKS = [127, 255, 256, 257, 643, 1024, 1025, 1152, 1153]


@pytest.mark.parametrize("nk", PLAN_NKS)
def test_exp_plan_covers_the_panel_and_keeps_its_max(nk):
    """The plan splits the keys into at most 16 non-empty slices (a row group's warps) of a
    multiple of 16 keys, at most 128, that cover the panel exactly, or past the capacity
    sends it to the two-sweep loop; the final max taken from the slices' maxes is the two-sweep loop's
    (64-key tiles) bit for bit."""
    plan = fa._exp_plan(nk)
    if nk > fa._EXP_MAX_KEYS:
        assert plan is None
        return
    splits, size = plan
    assert 1 <= splits <= fa._EXP_WARPS and size % 16 == 0 and size <= fa._EXP_SLICE
    ranges = _slices(nk, plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    assert all(a < b for a, b in ranges)  # none empty
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))  # contiguous
    q, k, _ = (_split(t) for t in _inputs(37, nk, seed=nk))
    slice_max = torch.stack([(q @ k[..., a:b, :].transpose(-1, -2)).amax(-1)
                             for a, b in ranges]).amax(0)
    two_sweep = torch.full(slice_max.shape, -math.inf)
    for k0 in range(0, nk, TILE):
        two_sweep = torch.maximum(two_sweep,
                                  (q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)).amax(-1))
    assert torch.equal(slice_max, two_sweep)
