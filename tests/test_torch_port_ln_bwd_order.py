"""The arithmetic order of K4's fp32 path (``pcdiff_torch/csrc/ln_dense_bwd.cu``) against
its plain version, on the CPU, at the flagship's width (C = 256, F = 1024 or three 256-wide
outputs) and at a ragged shape.

K4's fp32 path (the train step's) runs five launches. Where an output has an activation, K3's
fp32 block recomputes z = y W^T with fp32 FMA over 32-deep stages of C and forms
gz = g act'(z + b); then dy = sum_i gz_i W_i accumulates over 32-deep stages of the outputs'
F, in output order, and the blocks of the first column tile sum each stage's gz columns into
a 128-row tile's partial db (eight lanes a column, each over the rows l, l + 8, ..., then a
butterfly over the eight); the LN backward forms dx a row at a time and each 128-row tile's
partial dscale and dbias (a half-warp a row: a lane over its eight rows, the two halves of a
warp added, then the eight warps in order); dW_i = gz_i^T y accumulates over 32-row stages in
each row range of the wrapper's plan (``ld._dw_rows``, ``ld._dw_ranges``); a last launch sums
the ranges' and tiles' partials in a fixed order (in order, or, for 64 partials or more, 32
lanes in order and a butterfly over them). This file repeats that order in torch (each
stage's sum taken by matmul, whose order inside a stage is the library's) and holds it to
``_torch_ln_denses_bwd`` within ``chip_smoke.K4_TOL`` (fp32: 1e-4 of max |ref|, per
gradient). Readings of the sound order at these inputs: 4.1e-7 to 6.3e-7 of max |ref| (the
worst gradient of each case).

Which faults the limit catches: act' taken at z without its bias (1.6e-1 to 3.2e-1 of max
|ref| in every gradient) and a weight-gradient plan whose ranges overlap by one stage (a row
counted twice: 3.4e-1 in dW). The emulation lives here only; nothing on the port's path
calls it.
"""

import numpy as np
import pytest
import torch

from pcdiff_torch.ops import ln_dense as ld

torch.set_num_threads(2)

EPS = 1e-5
K4_TOL = 1e-4  # chip_smoke.py: K4 against its plain version, fp32, of max |ref| per gradient
TILE, DEPTH = 128, 32  # the fp32 path's row tile and stage depth (csrc/ln_dense_bwd.cu)
ACTS = [None, "gelu", "gelu_tanh", "quick_gelu"]


def _inputs(seed, rows, c, fs, with_bias=True):
    """chip_smoke._ln_bwd_inputs' distribution, from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift)

    x = t(rows, c, scale=2.0, shift=0.5)
    ws = [t(f, c, scale=1 / 16) for f in fs]
    bs = [t(f, scale=0.2) if with_bias else None for f in fs]
    gs = [t(rows, f) for f in fs]
    return x, t(c, scale=0.2, shift=1.0), t(c, scale=0.2), ws, bs, gs


def _tiles(v, rows):
    """v [rows, ...] zero-padded to whole 128-row tiles, as [tiles, 128, ...]."""
    pad = -rows % TILE
    v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) if pad else v
    return v.reshape(-1, TILE, *v.shape[1:])


def _in_order(parts):
    """parts[0] + parts[1] + ..., one at a time."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


LONG_CHAIN = 64  # csrc/ln_dense_bwd.cu: a chain this long is summed by a warp


def _chain(parts):
    """The sum launch's order: in order, or, for LONG_CHAIN partials or more, lane l of 32
    over parts l, l + 32, ... in order, then a butterfly over the lanes."""
    if len(parts) < LONG_CHAIN:
        return _in_order(parts)
    s = torch.stack([_in_order(parts[lane::32]) for lane in range(32)])
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[lanes ^ off]
    return s[0]


def _db_partials(gz, rows):
    """The dy launch's db: per tile, lane l of eight sums rows l, l + 8, ... in order, then a
    butterfly over the eight lanes; the tiles in order."""
    t = _tiles(gz, rows).reshape(-1, TILE // 8, 8, gz.shape[1])  # [tile][j][l]: row 8 j + l
    s = _in_order(list(t.unbind(1)))  # [tile][l]
    lanes = torch.arange(8)
    for off in (1, 2, 4):
        s = s + s[:, lanes ^ off]
    return _chain(list(s[:, 0]))


def _ln_partials(v, rows):
    """The ln launch's column sums: per tile, warp w takes rows 16 w + 2 i + half; a lane
    sums its eight rows in order, the halves are added, then the warps in order; the tiles in
    order."""
    t = _tiles(v, rows).reshape(-1, 8, 8, 2, v.shape[1])  # [tile][warp][i][half]
    s = _in_order(list(t.unbind(2)))  # [tile][warp][half]
    s = s[:, :, 0] + s[:, :, 1]
    return _chain(list(_in_order(list(s.unbind(1)))))


def _emulate_k4(x, scale, bias, ws, bs, gs, acts, per, bias_in_z=True, overlap=0):
    """K4's fp32 order (the module docstring). ``bias_in_z=False`` takes act' at z without
    its bias; ``overlap`` starts each weight-gradient range but the first that many rows
    early."""
    rows, c = x.shape
    xhat, rstd, y = ld._normalise(x, scale, bias, EPS, torch.float32)
    gzs = []
    for w, b, g, act in zip(ws, bs, gs, acts):
        if act is not None:
            z = torch.zeros(rows, w.shape[0])
            for k0 in range(0, c, DEPTH):
                z = z + y[:, k0:k0 + DEPTH] @ w[:, k0:k0 + DEPTH].t()
            if b is not None and bias_in_z:
                z = z + b
            g = g * ld._act_grad(z, act)
        gzs.append(g)
    dy = torch.zeros(rows, c)
    for gz, w in zip(gzs, ws):
        for f0 in range(0, w.shape[0], DEPTH):
            dy = dy + gz[:, f0:f0 + DEPTH] @ w[f0:f0 + DEPTH]
    dbs = [None if b is None else _db_partials(gz, rows) for gz, b in zip(gzs, bs)]
    dxh = dy * scale
    m1 = dxh.sum(-1, keepdim=True) / c
    m2 = (dxh * xhat).sum(-1, keepdim=True) / c
    dx = rstd * (dxh - m1 - xhat * m2)
    dscale, dbias = _ln_partials(dy * xhat, rows), _ln_partials(dy, rows)
    dws = []
    for gz in gzs:
        parts = []
        for lo, hi in ld._dw_ranges(rows, per):
            lo = max(0, lo - overlap)
            acc = torch.zeros(gz.shape[1], c)
            for r0 in range(lo, hi, DEPTH):
                r1 = min(hi, r0 + DEPTH)
                acc = acc + gz[r0:r1].t() @ y[r0:r1]
            parts.append(acc)
        dws.append(_chain(parts))
    return dx, dscale, dbias, dws, dbs


def _worst(got, ref):
    """The largest over the gradients of max |got - ref| / max |ref|."""
    worst = 0.0
    for a, r in zip(_flat(got), _flat(ref)):
        worst = max(worst, ((a - r).abs().max() / r.abs().max()).item())
    return worst


def _flat(out):
    dx, dscale, dbias, dws, dbs = out
    return [dx, dscale, dbias, *dws, *[d for d in dbs if d is not None]]


def _case(seed, rows, c, fs, acts, slots, with_bias=True):
    x, scale, bias, ws, bs, gs = _inputs(seed, rows, c, fs, with_bias)
    per = ld._dw_rows(rows, tuple(fs), c, TILE, DEPTH, slots)
    ref = ld._torch_ln_denses_bwd(x, scale, bias, ws, bs, gs, EPS, torch.float32, acts)
    return (x, scale, bias, ws, bs, gs, acts, per), ref


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_k4_fp32_order_within_card_tolerance_fc1(act):
    """C = 256, F = 1024 over five row tiles and four weight-gradient ranges."""
    args, ref = _case(ACTS.index(act), 640, 256, (1024,), [act], slots=64)
    assert len(ld._dw_ranges(640, args[-1])) == 4
    assert _worst(_emulate_k4(*args), ref) <= K4_TOL


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no bias"])
def test_k4_fp32_order_within_card_tolerance_qkv(with_bias):
    """The three-output qkv site (no activation: gz is g itself), several tiles and ranges."""
    args, ref = _case(5, 600, 256, (256, 256, 256), [None] * 3, slots=48, with_bias=with_bias)
    assert len(ld._dw_ranges(600, args[-1])) > 1
    got = _emulate_k4(*args)
    assert (got[4][0] is None) == (not with_bias)
    assert _worst(got, ref) <= K4_TOL


def test_k4_fp32_order_at_a_ragged_shape():
    """C = 96 (a ragged 128-column tile), three 64-wide outputs (the second without a bias),
    mixed activations, 300 rows (a ragged last row tile and range)."""
    x, scale, bias, ws, bs, gs = _inputs(7, 300, 96, (64, 64, 64))
    bs[1] = None
    acts = ["quick_gelu", "gelu_tanh", None]
    per = ld._dw_rows(300, (64, 64, 64), 96, TILE, DEPTH, 8)
    ref = ld._torch_ln_denses_bwd(x, scale, bias, ws, bs, gs, EPS, torch.float32, acts)
    assert 300 % per and len(ld._dw_ranges(300, per)) > 1
    assert _worst(_emulate_k4(x, scale, bias, ws, bs, gs, acts, per), ref) <= K4_TOL


def test_k4_fp32_order_with_long_chains():
    """65 row tiles and 65 weight-gradient ranges: the sum launch takes each of these chains
    by a warp (lane sums, then a butterfly)."""
    args, ref = _case(9, 65 * TILE - 50, 256, (64,), ["gelu"], slots=132)
    assert len(ld._dw_ranges(65 * TILE - 50, args[-1])) >= LONG_CHAIN
    assert _worst(_emulate_k4(*args), ref) <= K4_TOL


@pytest.mark.parametrize("fault", ["act' without the bias", "overlapping ranges"])
def test_k4_tolerance_catches_structural_faults(fault):
    """An order with act' at z without its bias, or with a row counted twice in dW, fails
    the card's limit by more than a hundred times."""
    args, ref = _case(11, 640, 256, (1024,), ["gelu"], slots=64)
    kw = {"act' without the bias": dict(bias_in_z=False),
          "overlapping ranges": dict(overlap=DEPTH)}[fault]
    assert _worst(_emulate_k4(*args, **kw), ref) > 100 * K4_TOL


# ---- the wrapper's plan of the weight-gradient launch (pure Python) ----

# the train step's sites (rows, outputs), as chip_smoke.TRAIN_LN_SITES has them
TRAIN_SITES = [(20576, (256, 256, 256)), (20576, (1024,)), (20576, (256,)), (32768, (256, 256)),
               (32768, (1024,)), (32768, (256,)), (20576, (256, 256)), (32800, (256, 256, 256)),
               (32800, (1024,)), (8224, (256, 256, 256)), (8224, (1024,)), (8160, (256,)),
               (8160, (256, 256, 256)), (4064, (256,)), (4064, (1024,))]


def _covers_in_order(rows, ranges):
    return ranges[0][0] == 0 and ranges[-1][1] == rows and all(
        lo < hi and hi == nxt for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(rows, 0)]))


@pytest.mark.parametrize("slots", [132, 264], ids=["one block an SM", "two"])
@pytest.mark.parametrize("rows,fs", TRAIN_SITES, ids=lambda v: str(v))
def test_dw_plan_covers_every_row_once_and_fills_the_card(rows, fs, slots):
    per = ld._dw_rows(rows, fs, 256, TILE, DEPTH, slots)
    ranges = ld._dw_ranges(rows, per)
    assert per % DEPTH == 0 and _covers_in_order(rows, ranges)
    blocks = sum(-(-f // TILE) for f in fs) * 2 * len(ranges)
    assert 0.9 * slots <= blocks <= slots, (per, len(ranges), blocks)


@pytest.mark.parametrize("rows", [1, 31, 32, 100, 128])
def test_dw_plan_at_one_tile(rows):
    """Rows within one 128-row tile: ranges of whole stages that still cover every row once."""
    per = ld._dw_rows(rows, (64,), 96, TILE, DEPTH, 132)
    ranges = ld._dw_ranges(rows, per)
    assert per % DEPTH == 0 and _covers_in_order(rows, ranges)
    assert len(ranges) == -(-rows // DEPTH)
