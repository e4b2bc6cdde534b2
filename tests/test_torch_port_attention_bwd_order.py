"""The arithmetic order of the attention backward kernel K2 (``pcdiff_torch/csrc/
attention_mh_bwd.cu``) against its plain version, on the CPU, at the flagship's width.

K2 runs in two launches. The first walks the keys in tiles of 64 and keeps, per query row,
the online max m, the sum l of exp(s - m) and the sum of dp exp(s - m), both rescaled by
exp2((m_old - m_new) log2e) as m grows; it records (m log2e, 1/l, D = that sum times 1/l).
Its second sweep forms P = exp2(fma(s, log2e, -m log2e)) * (1/l) and ds = P (dp - D),
rounds ds to bf16 and accumulates dq = ds K. The second launch walks the queries in tiles
of 64 and, with each query's record, forms P^T and ds^T the same way, rounds both to bf16
and accumulates dv = P^T g and dk = ds^T q. This file repeats that order in torch (fp32
copies of the bf16 operands; the tensor cores' fp32 sums taken by matmul) and holds it to
``_torch_attention_mh_bwd(..., mxu_dtype=bf16)`` within the tolerance ``chip_smoke.py``
holds the kernel to on the card (``K2_TOL``: 1e-2 of max |ref| per gradient), at 8 heads of
32, two rows, the backbone's z (643²), read (643 x 1024) and write (1024 x 643) sites and
the ragged point-cloud encoder (1025²), with fp32 and bf16 inputs. Readings of the sound
order, the worst gradient of a case: 1.0e-4 to 7.7e-4 of max |ref| with fp32 inputs, 7.3e-4
to 2.1e-3 with bf16 ones (whose bf16 outputs add their own rounding: one ulp of the largest
element is 2^-8 = 3.9e-3 of max |ref|).

Which faulty orders the limit tells apart, with fp32 inputs at the three backbone sites: an
order that forms P with the running max of a single sweep and never rescales it (a
one-sweep design that forgets the final max) reads 4.7 to 6.4 and fails. The subtler faults
do not fail it: FA2's rowsum(dO O) in place of rowsum(dp P), with O the forward's output as
K1 writes it (K1 rounds the unnormalised P to bf16), reads 2.7e-3 to 3.4e-3, and ds left
unrounded 1.9e-3 to 2.9e-3, both under the 1e-2 limit though above the sound order's
readings. So K2_TOL cannot see a single bf16 rounding of P or ds; this file shows only that
the kernel's order stays within it. The emulation lives here only; nothing on the port's
path calls it.
"""

import math

import numpy as np
import pytest
import torch

from pcdiff_torch.ops import flash_attention as fa

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

HEADS, D, ROWS, TILE = 8, 32, 2, 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
K2_TOL = 1e-2  # chip_smoke.py: K2 against its plain version, of max |ref| per gradient
SHAPES = {  # (Nq, Nk): the backbone's sites and the point-cloud encoder (ragged both ways)
    "z": (643, 643),
    "read": (643, 1024),
    "write": (1024, 643),
    "ppcd encoder": (1025, 1025),
}


def _exp2_fma(s, off):
    """exp2(fma(s, log2e, -off)) in fp32: the product and the difference rounded once."""
    return torch.exp2((s.double() * LOG2E.double() - off.double()).float())


def _bf16(t):
    return t.bfloat16().float()


def _row_records(q, k, v, g):
    """Launch (a)'s first sweep: per query row (m log2e, 1/l, rowsum(dp P)) from the online
    max, sum and dp-weighted sum over 64-key tiles."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    dl = torch.zeros_like(m)
    for k0 in range(0, k.shape[-2], TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        dp = g @ v[..., k0:k0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = _exp2_fma(s, m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        dl = dl * alpha + (dp * p).sum(-1, keepdim=True)
        m = m_new
    recip = 1.0 / l
    return m * LOG2E, recip, dl * recip


def _emulate_k2(q, k, v, g, row_d=None, round_ds=True, final_max=True):
    """K2's order on [B, H, N, D] fp32 copies of bf16 operands. ``row_d`` replaces
    rowsum(dp P) (FA2's rowsum(dO O), for the tests below); ``round_ds`` False leaves ds
    in fp32; ``final_max`` False forms P with the running max of the first sweep's tile and
    never rescales it (a one-sweep order)."""
    ml, recip, drow = _row_records(q, k, v, g)
    if row_d is not None:
        drow = row_d
    rnd = _bf16 if round_ds else (lambda t: t)
    dq = torch.zeros(q.shape)
    m_run = torch.full(q.shape[:-1] + (1,), -math.inf)
    for k0 in range(0, k.shape[-2], TILE):  # launch (a), sweep 2
        kt = k[..., k0:k0 + TILE, :]
        s = q @ kt.transpose(-1, -2)
        dp = g @ v[..., k0:k0 + TILE, :].transpose(-1, -2)
        off = ml
        if not final_max:
            m_run = torch.maximum(m_run, s.amax(-1, keepdim=True))
            off = m_run * LOG2E
        big_p = _exp2_fma(s, off) * recip
        dq = dq + rnd(big_p * (dp - drow)) @ kt
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, q.shape[-2], TILE):  # launch (b), per query tile
        qt, gt = q[..., q0:q0 + TILE, :], g[..., q0:q0 + TILE, :]
        s = qt @ k.transpose(-1, -2)
        dp = gt @ v.transpose(-1, -2)
        big_p = _exp2_fma(s, ml[..., q0:q0 + TILE, :]) * recip[..., q0:q0 + TILE, :]
        ds = rnd(big_p * (dp - drow[..., q0:q0 + TILE, :]))
        dv = dv + _bf16(big_p).transpose(-1, -2) @ gt
        dk = dk + ds.transpose(-1, -2) @ qt
    return dq, dk, dv


def _k1_output(q, k, v, out_dtype):
    """K1's forward output in the input dtype: P rounded to bf16 against the running max,
    the output rescaled by alpha and divided by the fp32 row sum after PV."""
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = _exp2_fma(s, m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _bf16(p) @ v[..., k0:k0 + TILE, :]
        m = m_new
    return (o * (1.0 / l)).to(out_dtype).float()


def _inputs(nq, nk, seed, dtype):
    """chip_smoke.py's inputs: q scaled as a pre-scaled query, k, v and g standard normal."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((ROWS, nq, HEADS * D), dtype=np.float32) * (2 / math.sqrt(D))
    k = rng.standard_normal((ROWS, nk, HEADS * D), dtype=np.float32)
    v = rng.standard_normal((ROWS, nk, HEADS * D), dtype=np.float32)
    g = rng.standard_normal((ROWS, nq, HEADS * D), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v, g))


def _split(t):
    """[B, N, H*D] -> [B, H, N, D]: fp32 copies of the bf16 operands the kernel stages."""
    b, n, _ = t.shape
    return _bf16(t).reshape(b, n, HEADS, D).transpose(1, 2)


def _errors(site, dtype, **order):
    """Each gradient's max abs error over max |ref|, the emulated order against the plain
    version, the emulation's outputs in the input dtype as the kernel writes them."""
    nq, nk = SHAPES[site]
    q, k, v, g = _inputs(nq, nk, seed=10 + list(SHAPES).index(site), dtype=dtype)
    ref = fa._torch_attention_mh_bwd(q, k, v, g, HEADS, mxu_dtype=torch.bfloat16)
    got = _emulate_k2(*(_split(t) for t in (q, k, v, g)), **order)
    out = []
    for name, a, want, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        a = fa._fold(a, like)
        assert a.dtype == dtype and a.shape == want.shape and torch.isfinite(a).all(), name
        out.append(((a.float() - want.float()).abs().max() / want.float().abs().max()).item())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", list(SHAPES))
def test_k2_order_within_card_tolerance(site, dtype):
    errs = _errors(site, dtype)
    assert max(errs) <= K2_TOL, f"K2 {site}: dq, dk, dv errors {errs} of max |ref|"


def _fa2_row_d(site, dtype):
    """FA2's rowsum(dO O), with O the forward's output as K1 writes it."""
    nq, nk = SHAPES[site]
    q, k, v, g = (_split(t) for t in _inputs(nq, nk, 10 + list(SHAPES).index(site), dtype))
    return (g * _k1_output(q, k, v, dtype)).sum(-1, keepdim=True)


WRONG_ORDERS = {  # name: (the order's arguments, whether K2_TOL fails it)
    "rowsum(dO O)": (lambda site, dtype: {"row_d": _fa2_row_d(site, dtype)}, False),
    "ds unrounded": (lambda site, dtype: {"round_ds": False}, False),
    "running max, one sweep": (lambda site, dtype: {"final_max": False}, True),
}


@pytest.mark.parametrize("order", list(WRONG_ORDERS))
@pytest.mark.parametrize("site", ["z", "read", "write"])
def test_k2_tolerance_against_wrong_orders(site, order):
    """fp32 inputs: which faulty orders the per-gradient limit fails (see the docstring)."""
    args, fails = WRONG_ORDERS[order]
    errs = _errors(site, torch.float32, **args(site, torch.float32))
    assert (max(errs) > K2_TOL) is fails, f"{order} {site}: errors {errs} of max |ref|"
