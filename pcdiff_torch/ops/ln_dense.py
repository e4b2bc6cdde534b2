"""Fused LayerNorm -> projection(s), forward and backward: ``[act_i(LN(x) W_i^T + b_i)]``
without the normalised tensor ever reaching device memory.

Counterpart of :func:`pcdiff.ops.ln_dense.fused_ln_denses` and its custom VJP.
:func:`fused_ln_denses` is a :class:`torch.autograd.Function`. On a CUDA tensor its
forward launches ``csrc/ln_dense.cu`` (it replaces the TPU kernel
``pcdiff/ops/ln_dense.py::_ln_denses_kernel``) and its backward ``csrc/ln_dense_bwd.cu``
(it replaces ``_ln_denses_bwd_kernel``); on a CPU tensor they run :func:`_torch_ln_denses`
and :func:`_torch_ln_denses_bwd`, the plain PyTorch versions of the same functions. The
backward recomputes from the saved ``(x, scale, bias, weights, biases)``, as the JAX custom
VJP does. Each kernel's note (what bounds it on the H100, what its design does about it)
is at the head of its source.

Layout: the weights are in the ``nn.Linear`` layout ``[F_i, C]`` (the JAX package's
kernels are ``[C, F_i]``), and so are their gradients. Numerics, as the TPU kernels': fp32
fast-variance LN statistics and fp32 affine, the normalised rows cast to the product dtype
(bf16 when the output is bf16, fp32 when it is fp32), fp32 accumulation, bias and
activation on the fp32 accumulator, one cast out. ``gelu`` is the exact-erf form through
``_erf_f32``, XLA's erf rational that the TPU kernel reproduces. In the backward,
g * act'(z) is rounded to the product dtype before its products, the bias gradient is
summed from it before that rounding, and the parameter gradients are fp32.

The forward kernel takes W in the product dtype: for a bf16 output the wrapper casts each
fp32 weight to bf16 before the launch, as the JAX wrapper casts its kernels
(:func:`_product_weight`, once per version of the parameter), so no block converts W.
The backward kernel has two paths: fp32 outputs (the train step's) take the fp32 W as it
is, through launches whose weight-gradient row ranges the wrapper plans from the card's
tiling (:func:`_dw_rows` on :func:`_bwd_tiling_on`); bf16 outputs take the WMMA path.

Both kernels have one domain (:func:`_in_domain`: fp32 or bf16, 0 < C <= 256 with
C % 32 == 0, fewer than 2^31 rows, 1 to 3 outputs with F % 64 == 0), a pure check made
before any launch. A CUDA tensor outside it takes the plain versions, as the JAX package's
``use_ln_dense`` sends such shapes to XLA; nothing is caught, and ``_launch`` still refuses
a shape outside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _native

__all__ = [
    "fused_ln_denses",
    "set_lndense_backend",
    "launches",
    "bwd_launches",
]

_BACKEND = "kernel"  # kernel | plain
_ACT_CODES = {None: 0, "gelu": 1, "gelu_tanh": 2, "quick_gelu": 3}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_C = 256
_TILE_F = 64
_MAX_ROWS = 2**31 - 1  # the C interface's int rows
# a block's LayerNorm prologue counted in output tiles of work (128 x 128: a bf16 tile is a
# short tensor-core product with an epilogue, an fp32 tile a long FMA one)
_LN_TILES = {torch.bfloat16: 0.5, torch.float32: 0.25}
# the bf16 copies of fp32 weights (:func:`_product_weight`), held while the weight lives
_W_BF16 = WeakIdKeyDictionary()

launches = 0  # forward kernel launches since the last reset (chip_smoke.py resets it)
bwd_launches = 0  # backward kernel launches, likewise
_fn = None
_tiling_fn = None
_bwd_fns: dict = {}
_bwd_tiling = None

# XLA's f32 erf rational (xla/client/lib/math.cc ErfImpl32), as pcdiff/ops/ln_dense.py.
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def set_lndense_backend(name: str) -> None:
    """'kernel' (default) launches the CUDA kernels for CUDA tensors; 'plain' runs the
    plain PyTorch versions on every device (for comparing the two on the card)."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown LN+Dense backend {name!r}")
    _BACKEND = name


def _poly(x, coeffs):
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def _erf_f32(x):
    x = torch.clamp(x, -4.0, 4.0)
    x2 = x * x
    return x * _poly(x2, _ERF_ALPHA) / _poly(x2, _ERF_BETA)


def _apply_act(o32, act):
    """The epilogue activations of pcdiff.ops.ln_dense._apply_act(..., erf=_erf_f32)."""
    if act is None:
        return o32
    if act == "gelu":
        return o32 * 0.5 * (1.0 + _erf_f32(o32 * (2.0**-0.5)))
    if act == "quick_gelu":
        return o32 / (1.0 + torch.exp(torch.clamp(-1.702 * o32, -30.0, 30.0)))
    if act == "gelu_tanh":
        u2 = 1.5957691216057308 * (o32 + 0.044715 * o32 * o32 * o32)
        return o32 / (1.0 + torch.exp(torch.clamp(-u2, -30.0, 30.0)))
    raise ValueError(f"unknown activation {act!r}")


def _act_grad(z, act):
    """d act(z) / dz, as pcdiff.ops.ln_dense._act_grad (None for no activation)."""
    if act is None:
        return None
    if act == "gelu":
        phi = torch.exp(z * z * -0.5) * 0.3989422804014327  # 1/sqrt(2 pi)
        cdf = 0.5 * (1.0 + _erf_f32(z * (2.0**-0.5)))
        return cdf + z * phi
    if act == "quick_gelu":
        s = 1.0 / (1.0 + torch.exp(torch.clamp(-1.702 * z, -30.0, 30.0)))
        return s * (1.0 + 1.702 * z * (1.0 - s))
    if act == "gelu_tanh":
        # f = z sigmoid(2u), u = k (z + a z^3): f' = s + 2 z k (1 + 3 a z^2) s (1 - s)
        u2 = 1.5957691216057308 * (z + 0.044715 * z * z * z)
        s = 1.0 / (1.0 + torch.exp(torch.clamp(-u2, -30.0, 30.0)))
        up = 0.7978845608028654 * (1.0 + 0.134145 * z * z)
        return s + 2.0 * z * up * s * (1.0 - s)
    raise ValueError(f"unknown activation {act!r}")


def _product_dtype(out_dtype):
    """bf16 products for a bf16 output; fp32 (fp64 for gradcheck) products otherwise."""
    return out_dtype if out_dtype in (torch.float32, torch.float64) else torch.bfloat16


def _acc_dtype(out_dtype):
    return torch.float64 if out_dtype == torch.float64 else torch.float32


def _normalise(x, scale, bias, eps, acc):
    """(xhat, rstd, y32): the fast-variance LayerNorm in ``acc`` and its affine."""
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    return xhat, rstd, xhat * scale.to(acc) + bias.to(acc)


def _torch_ln_denses(x, scale, bias, weights, biases, eps, out_dtype, acts):
    """Plain version of the forward kernel, with its dtype casts."""
    mxu, acc = _product_dtype(out_dtype), _acc_dtype(out_dtype)
    y = _normalise(x, scale, bias, eps, acc)[2].to(mxu).to(acc)
    outs = []
    for w, b, act in zip(weights, biases, acts):
        o32 = torch.matmul(y, w.to(mxu).to(acc).t())
        if b is not None:
            o32 = o32 + b.to(acc)
        outs.append(_apply_act(o32, act).to(out_dtype))
    return outs


def _torch_ln_denses_bwd(x, scale, bias, weights, biases, gs, eps, out_dtype, acts):
    """Plain version of the backward kernel (``_ln_denses_bwd_kernel``), weights in the
    ``[F_i, C]`` layout. Returns (dx, dscale, dbias, [dW_i], [db_i or None]); dx in x's
    dtype, the parameter gradients fp32 (fp64 for fp64 inputs), summed over all rows."""
    mxu, acc = _product_dtype(out_dtype), _acc_dtype(out_dtype)
    c = x.shape[-1]
    xhat, rstd, y32 = _normalise(x, scale, bias, eps, acc)
    xhat, rstd = xhat.reshape(-1, c), rstd.reshape(-1, 1)
    y = y32.reshape(-1, c).to(mxu).to(acc)
    dy = torch.zeros_like(y)
    dws, dbs = [], []
    for w, b, g, act in zip(weights, biases, gs, acts):
        wm = w.to(mxu).to(acc)
        g32 = g.reshape(-1, w.shape[0]).to(acc)
        if act is not None:
            z = torch.matmul(y, wm.t())
            if b is not None:
                z = z + b.to(acc)
            g32 = g32 * _act_grad(z, act)
        gz = g32.to(mxu).to(acc)
        dbs.append(None if b is None else g32.sum(dim=0))
        dws.append(torch.matmul(gz.t(), y))  # [F, C]
        dy = dy + torch.matmul(gz, wm)
    dscale = (dy * xhat).sum(dim=0)
    dbias = dy.sum(dim=0)
    dxhat = dy * scale.to(acc)
    m1 = dxhat.sum(dim=-1, keepdim=True) / c
    m2 = (dxhat * xhat).sum(dim=-1, keepdim=True) / c
    dx = (rstd * (dxhat - m1 - xhat * m2)).reshape(x.shape).to(x.dtype)
    return dx, dscale, dbias, dws, dbs


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("ln_dense").pcdiff_ln_denses_fwd
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ptrs, ptrs, ptrs, ints, ints,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _product_weight(w):
    """``w`` (fp32 ``[F, C]``) in bf16 for the bf16 path. The copy is kept in ``_W_BF16``,
    keyed weakly on the tensor itself, and taken again while the tensor's storage and
    version counter are unchanged, so a parameter is cast once until an in-place update (an
    optimizer step, ``copy_``, a ``load_state_dict``) moves its version; writes through
    ``.data`` bypass the counter and are not seen. An inference tensor, which has no
    counter, is cast every call."""
    if w.is_inference():
        return w.to(torch.bfloat16)
    key = (w.data_ptr(), w._version)
    cached = _W_BF16.get(w)
    if cached is None or cached[0] != key:
        cached = (key, w.detach().to(torch.bfloat16))
        _W_BF16[w] = cached
    return cached[1]


def _tiling_kernel_fn():
    global _tiling_fn
    if _tiling_fn is None:
        fn = _native.library("ln_dense").pcdiff_ln_denses_tiling
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ctypes.c_int] * 3 + [ip] * 3
        fn.restype = ctypes.c_int
        _tiling_fn = fn
    return _tiling_fn


@functools.lru_cache(maxsize=None)
def _tiling(device: int, x_dtype, out_dtype, c: int) -> tuple:
    """(rows a block, columns a tile, blocks the card holds at once) of the forward kernel's
    instantiation at width ``c`` on CUDA device ``device``: the first two from the kernel's
    own constants, the last from its occupancy at the launch's shared memory times the
    card's SM count."""
    bm, bn, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _tiling_kernel_fn()(int(x_dtype == torch.bfloat16),
                                  int(out_dtype == torch.bfloat16), c, ctypes.byref(bm),
                                  ctypes.byref(bn), ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"ln_dense tiling query failed: cudaError_t {err}, "
                           f"{per_sm.value} blocks an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bm.value, bn.value, per_sm.value * sms


@functools.lru_cache(maxsize=1024)
def _groups(rows: int, fs: tuple, bm: int, bn: int, slots: int, ln_tiles: float) -> int:
    """How many column groups the forward kernel splits the outputs' tiles into, one block
    per (``bm``-row tile, group), each recomputing its rows' LayerNorm (``ln_tiles`` tiles
    of work): the count that minimises waves x (tiles a block + its LayerNorm) over the
    ``slots`` blocks the card holds at once, the fewest groups on a tie."""
    tiles = sum(-(-f // bn) for f in fs)
    row_tiles = -(-rows // bm)
    cost = {g: -(-row_tiles * g // slots) * (-(-tiles // g) + ln_tiles)
            for g in range(1, tiles + 1)}
    return min(cost, key=lambda g: (cost[g], g))


def _column_groups(x, fs: tuple, out_dtype) -> int:
    """The column groups of a launch on ``x`` (:func:`_groups` on the card's tiling)."""
    c = x.shape[-1]
    bm, bn, slots = _tiling(x.device.index, x.dtype, out_dtype, c)
    return _groups(x.numel() // c, fs, bm, bn, slots, _LN_TILES[out_dtype])


def _check_param(t, shape, device, what):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what} must be a contiguous fp32 tensor on {device}")
    if t.shape != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")


def _check(x, scale, bias, weights, biases, out_dtype, acts):
    n = len(weights)
    if not 1 <= n <= 3 or len(biases) != n or len(acts) != n:
        raise ValueError("1 to 3 projections, with one bias and one act each")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [..., C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be fp32 or bf16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be fp32 or bf16, got {out_dtype}")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if c % 32 or not 0 < c <= _MAX_C or not 0 < rows <= _MAX_ROWS:
        raise ValueError(f"the kernel takes 0 < C <= {_MAX_C} with C % 32 == 0 and 0 < rows "
                         f"<= {_MAX_ROWS}, got x {tuple(x.shape)}")
    if any(a not in _ACT_CODES for a in acts):
        raise ValueError(f"unknown activation in {acts!r}")
    dev = x.device
    _check_param(scale, (c,), dev, "LN scale")
    _check_param(bias, (c,), dev, "LN bias")
    for i, (w, b) in enumerate(zip(weights, biases)):
        f = w.shape[0]
        if f == 0 or f % _TILE_F:
            raise ValueError(f"the kernel takes F % {_TILE_F} == 0, got weight {tuple(w.shape)}")
        _check_param(w, (f, c), dev, f"weight {i}")
        if b is not None:
            _check_param(b, (f,), dev, f"bias {i}")
    return rows, c


def _launch(x, scale, bias, weights, biases, eps, out_dtype, acts, groups=None):
    """K3 on the card; ``groups`` (the column groups) defaults to :func:`_column_groups`'s
    and is set only by ``chip_smoke.py``'s timing of one group."""
    global launches
    n = len(weights)
    rows, c = _check(x, scale, bias, weights, biases, out_dtype, acts)
    dev = x.device
    outs = [torch.empty(x.shape[:-1] + (w.shape[0],), dtype=out_dtype, device=dev)
            for w in weights]
    fs = tuple(w.shape[0] for w in weights)
    if groups is None:
        groups = _column_groups(x, fs, out_dtype)
    if out_dtype == torch.bfloat16:
        weights = [_product_weight(w) for w in weights]
    vp = ctypes.c_void_p * 3
    ci = ctypes.c_int * 3
    pad = [None] * (3 - n)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n,
            vp(*[w.data_ptr() for w in weights], *pad),
            vp(*[None if b is None else b.data_ptr() for b in biases], *pad),
            vp(*[o.data_ptr() for o in outs], *pad),
            ci(*fs, *([0] * (3 - n))),
            ci(*[_ACT_CODES[a] for a in acts], *([0] * (3 - n))),
            rows, c, float(eps), int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), groups, _native.stream(dev))
    if err:
        raise RuntimeError(f"ln_dense kernel launch failed: cudaError_t {err}")
    launches += 1
    return outs


def _bwd_kernel_fn(path: str):
    """The C entry point of K4's ``path``: "fp32" (fp32 outputs) or "bf16"."""
    fn = _bwd_fns.get(path)
    if fn is None:
        fn = getattr(_native.library("ln_dense_bwd"), f"pcdiff_ln_denses_bwd_{path}")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        ptrs, ints = ctypes.POINTER(vp), ctypes.POINTER(i32)
        head = [
            vp, vp, vp, i32,                  # x, ln_scale, ln_bias, n_out
            ptrs, ptrs, ptrs, ints, ints,     # w, b, g, f, act
            vp, vp, vp, ptrs, ptrs,           # dx, dscale, dbias, dw, db
        ]
        if path == "fp32":  # dy, gz, ln_part, dw_part, db_part; rows, c, eps, x_bf16, groups,
            # dw_rows, stream
            tail = [vp, ptrs, vp, ptrs, ptrs, i32, i32, ctypes.c_float, i32, i32, i32, vp]
        else:  # stats, gz, ln_part, dw_part, db_part, dw_split; rows, c, eps, x_bf16, stream
            tail = [vp, ptrs, vp, ptrs, ptrs, ints, i32, i32, ctypes.c_float, i32, vp]
        fn.argtypes = head + tail
        fn.restype = ctypes.c_int
        _bwd_fns[path] = fn
    return fn


def _bwd_tiling_fn():
    global _bwd_tiling
    if _bwd_tiling is None:
        fn = _native.library("ln_dense_bwd").pcdiff_ln_denses_bwd_tiling
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        _bwd_tiling = fn
    return _bwd_tiling


@functools.lru_cache(maxsize=None)
def _bwd_tiling_on(device: int) -> tuple:
    """(tile side, stage depth, blocks the card holds at once) of K4's fp32 weight-gradient
    launch on CUDA device ``device``: the first two from the kernel's constants (the tile
    side is also the row tile of its dy and LayerNorm launches), the last from its occupancy
    times the card's SM count."""
    tile, depth, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _bwd_tiling_fn()(ctypes.byref(tile), ctypes.byref(depth), ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"ln_dense_bwd tiling query failed: cudaError_t {err}, "
                           f"{per_sm.value} blocks an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return tile.value, depth.value, per_sm.value * sms


_DW_FIXED = 2  # a weight-gradient block's fixed work (ring fill, partial tile out), in stages


@functools.lru_cache(maxsize=1024)
def _dw_rows(rows: int, fs: tuple, c: int, tile: int, depth: int, slots: int) -> int:
    """The rows a range of K4's fp32 weight-gradient launch takes, a multiple of ``depth``:
    one block per (``tile`` x ``tile`` tile of the dW_i, range of rows), the count of ranges
    that minimises waves x (stages a block + its fixed work) over the ``slots`` blocks the card
    holds at once, the fewest ranges on a tie."""
    tiles = sum(-(-f // tile) for f in fs) * -(-c // tile)
    steps = -(-rows // depth)
    best = None
    for n in range(1, steps + 1):
        per = -(-steps // n)  # stages a range
        ranges = -(-steps // per)
        key = (-(-tiles * ranges // slots) * (per + _DW_FIXED), ranges)
        if best is None or key < best[0]:
            best = (key, per)
    return best[1] * depth


def _dw_ranges(rows: int, per: int) -> list:
    """The row ranges ``[lo, hi)`` of the weight-gradient launch, ``per`` rows each: range r
    is block row ``r`` of the grid (csrc/ln_dense_bwd.cu ln_denses_bwd_dw_kernel)."""
    return [(lo, min(rows, lo + per)) for lo in range(0, rows, per)]


def _bwd_args(ts, n):
    return (ctypes.c_void_p * 3)(*[None if t is None else t.data_ptr() for t in ts],
                                 *([None] * (3 - n)))


def _bwd_ints(vals, n):
    return (ctypes.c_int * 3)(*vals, *([0] * (3 - n)))


def _launch_bwd_fp32(x, scale, bias, weights, biases, gs, eps, acts, rows, c):
    """K4's fp32 path: gz (outputs with an activation), dy, the LN backward, dW, the sums."""
    dev, n = x.device, len(weights)
    f32 = dict(dtype=torch.float32, device=dev)
    fs = tuple(w.shape[0] for w in weights)
    tile, depth, slots = _bwd_tiling_on(dev.index)
    per = _dw_rows(rows, fs, c, tile, depth, slots)
    ranges, tiles = len(_dw_ranges(rows, per)), -(-rows // tile)
    act_fs = tuple(f for f, a in zip(fs, acts) if a is not None)
    groups = _column_groups(x, act_fs, torch.float32) if act_fs else 1
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    dws = [torch.empty(w.shape, **f32) for w in weights]
    dbs = [None if b is None else torch.empty(f, **f32) for f, b in zip(fs, biases)]
    # scratch: dy (then y); g act'(z) where there is an activation; the row tiles' partial
    # dscale/dbias and db; the ranges' partial dW
    dy = torch.empty(rows, c, **f32)
    gz = [torch.empty(rows, f, **f32) if a is not None else None for f, a in zip(fs, acts)]
    ln_part = torch.empty(2, tiles, c, **f32)
    dw_part = [torch.empty(ranges, f, c, **f32) for f in fs]
    db_part = [None if b is None else torch.empty(tiles, f, **f32) for f, b in zip(fs, biases)]
    with torch.cuda.device(dev):
        err = _bwd_kernel_fn("fp32")(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n,
            _bwd_args(weights, n), _bwd_args(biases, n), _bwd_args(gs, n), _bwd_ints(fs, n),
            _bwd_ints([_ACT_CODES[a] for a in acts], n),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), _bwd_args(dws, n),
            _bwd_args(dbs, n), dy.data_ptr(), _bwd_args(gz, n), ln_part.data_ptr(),
            _bwd_args(dw_part, n), _bwd_args(db_part, n), rows, c, float(eps),
            int(x.dtype == torch.bfloat16), groups, per, _native.stream(dev))
    if err:
        raise RuntimeError(f"ln_dense_bwd kernel launch failed: cudaError_t {err}")
    return dx, dscale, dbias, dws, dbs


_WMMA_ROWS = 64  # rows per block of the bf16 path's row pass (csrc/ln_dense_bwd.cu wmma_path)
_WMMA_TARGET = 264  # blocks the bf16 path's weight-gradient pass aims for: two per SM of an H100


def _dw_split(rows: int, f: int, c: int) -> int:
    """How many row ranges the bf16 path's weight-gradient pass of one [F, C] gradient splits
    into, so that its (F/64) x (C/64) tiles give about two blocks per SM."""
    tiles = (f // _TILE_F) * max(1, c // _TILE_F)
    return max(1, min(-(-rows // _WMMA_ROWS), -(-_WMMA_TARGET // tiles)))


def _launch_bwd_bf16(x, scale, bias, weights, biases, gs, eps, acts, rows, c):
    """K4's bf16 path: the WMMA row pass, the weight-gradient pass per output, the sums."""
    dev, n = x.device, len(weights)
    f32 = dict(dtype=torch.float32, device=dev)
    blocks = -(-rows // _WMMA_ROWS)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    dws = [torch.empty(w.shape, **f32) for w in weights]
    dbs = [None if b is None else torch.empty(w.shape[0], **f32)
           for w, b in zip(weights, biases)]
    # scratch: LN (mean, rstd) per row; g * act'(z) in bf16 where there is an activation;
    # per-row-block partial sums of dscale/dbias and db; per-range dW partials
    stats = torch.empty(rows, 2, **f32)
    gz = [torch.empty(rows, w.shape[0], dtype=torch.bfloat16, device=dev) if a is not None
          else None for w, a in zip(weights, acts)]
    ln_part = torch.empty(2, blocks, c, **f32)
    splits = [_dw_split(rows, w.shape[0], c) for w in weights]
    dw_part = [torch.empty(sp, w.shape[0], c, **f32) for sp, w in zip(splits, weights)]
    db_part = [None if b is None else torch.empty(blocks, w.shape[0], **f32)
               for w, b in zip(weights, biases)]
    with torch.cuda.device(dev):
        err = _bwd_kernel_fn("bf16")(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n,
            _bwd_args(weights, n), _bwd_args(biases, n), _bwd_args(gs, n),
            _bwd_ints([w.shape[0] for w in weights], n),
            _bwd_ints([_ACT_CODES[a] for a in acts], n),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), _bwd_args(dws, n),
            _bwd_args(dbs, n), stats.data_ptr(), _bwd_args(gz, n), ln_part.data_ptr(),
            _bwd_args(dw_part, n), _bwd_args(db_part, n), _bwd_ints(splits, n), rows, c,
            float(eps), int(x.dtype == torch.bfloat16), _native.stream(dev))
    if err:
        raise RuntimeError(f"ln_dense_bwd kernel launch failed: cudaError_t {err}")
    return dx, dscale, dbias, dws, dbs


def _launch_bwd(x, scale, bias, weights, biases, gs, eps, out_dtype, acts):
    """K4 on the card: its fp32 path for fp32 outputs (the train step's), its bf16 path for
    bf16 ones. One count a call, whatever its launches."""
    global bwd_launches
    rows, c = _check(x, scale, bias, weights, biases, out_dtype, acts)
    for i, (w, g) in enumerate(zip(weights, gs)):
        if g.dtype != out_dtype or not g.is_contiguous() or g.numel() != rows * w.shape[0]:
            raise ValueError(f"gradient {i} must be a contiguous {out_dtype} [..., "
                             f"{w.shape[0]}] tensor, got {g.dtype} {tuple(g.shape)}")
    path = _launch_bwd_fp32 if out_dtype == torch.float32 else _launch_bwd_bf16
    out = path(x, scale, bias, weights, biases, gs, eps, acts, rows, c)
    bwd_launches += 1
    return out


def _in_domain(x, weights, out_dtype) -> bool:
    """K3's and K4's domain, checked before any launch: fp32 or bf16 ``x [..., C]`` and
    output, 0 < C <= 256 with C % 32 == 0, 0 < rows < 2^31, and 1 to 3 weights ``[F, C]``
    with F % 64 == 0."""
    c = x.shape[-1] if x.dim() else 0
    return (x.dim() >= 2 and x.dtype in _DTYPES and out_dtype in _DTYPES and x.numel() > 0
            and 0 < c <= _MAX_C and c % 32 == 0 and x.numel() // c <= _MAX_ROWS
            and 1 <= len(weights) <= 3
            and all(w.dim() == 2 and w.shape[0] > 0 and w.shape[0] % _TILE_F == 0
                    for w in weights))


def _on_card(x) -> bool:
    """Whether the kernel backend applies to x's device (raises on a device with neither
    path)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LN+Dense path for device {x.device}")
    return x.device.type == "cuda" and _BACKEND == "kernel"


def _use_kernel(x, weights, out_dtype) -> bool:
    return _on_card(x) and _in_domain(x, weights, out_dtype)


def _forward(x, scale, bias, weights, biases, eps, out_dtype, acts):
    """K3 or its plain version."""
    if _use_kernel(x, weights, out_dtype):
        return _launch(x, scale, bias, weights, biases, eps, out_dtype, acts)
    return _torch_ln_denses(x, scale, bias, weights, biases, eps, out_dtype, acts)


class _FusedLnDenses(torch.autograd.Function):
    """Forward: K3 or its plain version; saves (x, scale, bias, weights, biases) as the JAX
    custom VJP does. Backward: K4 or its plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype, acts, n, *params):
        weights, biases = params[:n], params[n:]
        ctx.eps, ctx.out_dtype, ctx.acts, ctx.n = eps, out_dtype, acts, n
        ctx.has_bias = tuple(b is not None for b in biases)
        ctx.save_for_backward(x, scale, bias, *weights, *[b for b in biases if b is not None])
        return tuple(_forward(x, scale, bias, weights, biases, eps, out_dtype, acts))

    @staticmethod
    def backward(ctx, *gs):
        x, scale, bias, *rest = ctx.saved_tensors
        n = ctx.n
        weights, present = rest[:n], iter(rest[n:])
        biases = [next(present) if hb else None for hb in ctx.has_bias]
        gs = [g.to(ctx.out_dtype).contiguous() for g in gs]
        if _use_kernel(x, weights, ctx.out_dtype):
            dx, dscale, dbias, dws, dbs = _launch_bwd(
                x, scale, bias, weights, biases, gs, ctx.eps, ctx.out_dtype, ctx.acts)
        else:
            dx, dscale, dbias, dws, dbs = _torch_ln_denses_bwd(
                x, scale, bias, weights, biases, gs, ctx.eps, ctx.out_dtype, ctx.acts)
        return (dx, dscale, dbias, None, None, None, None, *dws, *dbs)


def fused_ln_denses(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[Optional[torch.Tensor]],
    eps: float,
    out_dtype: torch.dtype,
    acts: Optional[Sequence[Optional[str]]] = None,
) -> list:
    """``[act_i(LN(x; scale, bias, eps) @ W_i^T + b_i)]`` as a list of ``[..., F_i]``
    tensors in ``out_dtype``. ``weights`` are ``[F_i, C]``; ``biases`` entries may be None;
    ``acts`` entries are None | 'gelu' | 'gelu_tanh' | 'quick_gelu'. Differentiable in x,
    the LN affine, the weights and the biases."""
    weights, biases = tuple(weights), tuple(biases)
    acts = (None,) * len(weights) if acts is None else tuple(acts)
    if not _native.needs_grad(x, scale, bias, *weights, *biases):
        return list(_forward(x, scale, bias, weights, biases, eps, out_dtype, acts))
    return list(_FusedLnDenses.apply(x, scale, bias, eps, out_dtype, acts, len(weights),
                                     *weights, *biases))
