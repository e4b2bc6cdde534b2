"""The whole pre-LN MLP in one kernel: ``act(LN(x) W1^T + b1) W2^T + b2``, with the
hidden activation never reaching device memory.

Counterpart of :func:`pcdiff.ops.ln_dense.fused_ln_mlp` and its custom VJP.
:func:`fused_ln_mlp` is a :class:`torch.autograd.Function`. On a CUDA tensor its forward
launches ``csrc/ln_mlp.cu`` (K5; it replaces the TPU kernel
``pcdiff/ops/ln_dense.py::_ln_mlp_kernel``; C, O <= 256, Point-E's wide rows C = O = 512,
F = 2048, and in bf16 base300M's C = O = 1024, F = 4096); on a CPU tensor, or under
``set_lndense_backend("plain")`` (the switch of the LN+Dense kernels, which the JAX
package's ``use_ln_mlp`` reads too), or outside its domain (:func:`_in_domain`), it runs
:func:`_torch_ln_mlp`, the plain version. The backward is ``_mlp_bwd``'s: it recomputes
the fc1 stage through K3 (:func:`pcdiff_torch.ops.ln_dense._launch`), takes fc2's two
gradients as products in the product dtype with fp32 accumulation (``torch.matmul``; the
JAX package computes them outside any Pallas kernel too), and the fc1 stage's gradient
through K4.

Layout: ``w1 [F, C]`` and ``w2 [O, F]``, the ``nn.Linear`` layout (the JAX package's are
``[C, F]`` and ``[F, O]``), fp32, and so are their gradients. Numerics, as the TPU
kernel's: the fc1 stage is exactly :func:`pcdiff_torch.ops.ln_dense._torch_ln_denses` (its
output dtype is the product dtype: bf16 for a bf16 output, fp32 for fp32), fc2 takes
operands in the product dtype with fp32 accumulation, adds an fp32 ``b2`` and casts once.
For a bf16 output the kernel takes both weights in bf16, cast once per parameter version by
K3's cache (:func:`pcdiff_torch.ops.ln_dense._product_weight`), so no block converts a
weight. The wide rows' fp32 path multiplies in 3xTF32 and takes each weight's TF32 parts,
split once per parameter version (:func:`_split_weight`), so no warp splits a weight either.
Past C = 512 (512 < C = O <= 1024, C % 128 == 0, F = 4C: base300M's MLP) the kernel takes bf16
outputs only, on clusters of four blocks, two row tiles by the two halves of O, the blocks of
an O half sharing each weight stage by a multicast (:func:`_pair_clusters` counts them); fp32
outputs at those widths take the
plain version, as the JAX package's ``use_ln_mlp`` sends them to XLA at base300M's rows (their
VMEM estimate, ~107 MiB, is past its 96 MiB budget; bf16's ~71 MiB is within it).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _native
from . import ln_dense as ld

__all__ = ["fused_ln_mlp", "launches", "width_launches"]

_MAX_C = 256
_MAX_O = 256
_MAX_C_WIDE = 512  # the wide rows: 256 < C = O <= 512, C % 128 == 0, F = 4 C (Point-E's MLP)
_MAX_C_PAIR = 1024  # and past them, bf16 only: 512 < C = O <= 1024 (base300M's MLP)
_PAIR_ROWS, _PAIR_CLUSTER = 64, 4  # there: rows a tile, blocks a cluster (two tiles)
# the TF32 parts of fp32 weights for the wide rows (:func:`_split_weight`), held while the
# weight lives
_W_TF32 = WeakIdKeyDictionary()

launches = 0  # K5 launches since the last reset (chip_smoke.py resets it)
width_launches: dict = {}  # K5 launches by C, likewise (clear() resets it)
_fn = None


def _torch_ln_mlp(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
    """Plain version of K5 (``_xla_ln_mlp``)."""
    mxu, acc = ld._product_dtype(out_dtype), ld._acc_dtype(out_dtype)
    (a,) = ld._torch_ln_denses(x, scale, bias, [w1], [b1], eps, out_dtype, [act])
    o32 = torch.matmul(a.to(mxu).to(acc), w2.to(mxu).to(acc).t()) + b2.to(acc)
    return o32.to(out_dtype)


def _torch_ln_mlp_fc2_bwd(a, g, w2, out_dtype):
    """fc2's gradients as ``_mlp_bwd`` forms them: (dW2 [O, F] fp32 (fp64 for fp64), db2,
    g_a [..., F] in a's dtype). The products take operands in the product dtype and
    accumulate in fp32, so a bf16 model's dW2 stays fp32, as the JAX package keeps it."""
    mxu, acc = ld._product_dtype(out_dtype), ld._acc_dtype(out_dtype)
    f, o = a.shape[-1], g.shape[-1]
    a2 = a.reshape(-1, f).to(mxu).to(acc)
    g2 = g.reshape(-1, o).to(mxu).to(acc)
    dw2 = torch.matmul(g2.t(), a2)
    db2 = g.reshape(-1, o).to(acc).sum(dim=0)
    g_a = torch.matmul(g2, w2.to(mxu).to(acc)).reshape(a.shape).to(a.dtype)
    return dw2, db2, g_a


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("ln_mlp").pcdiff_ln_mlp_fwd
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [i32] * 5 + [ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _wide(c: int, f: int, o: int) -> bool:
    """The wide rows' shapes: 256 < C = O <= 512 with C % 128 == 0 (the TPU kernel's lane
    alignment) and F = 4 C."""
    return _MAX_C < c <= _MAX_C_WIDE and c % 128 == 0 and o == c and f == 4 * c


def _pair(c: int, f: int, o: int, out_dtype) -> bool:
    """The wide rows past C = 512, which the kernel takes in bf16 only: 512 < C = O <= 1024
    with C % 128 == 0 and F = 4 C (base300M's MLP: C = 1024, F = 4096). The kernel
    (``csrc/ln_mlp.cu`` namespace ``pair``) takes them in clusters of four blocks: two 64-row
    tiles, each by the two halves of O, the two blocks of an O half receiving every weight stage
    once by a TMA multicast, the two of a row tile trading their halves of each h chunk."""
    return (out_dtype == torch.bfloat16 and _MAX_C_WIDE < c <= _MAX_C_PAIR and c % 128 == 0
            and o == c and f == 4 * c)


def _pair_clusters(rows: int) -> int:
    """The clusters of four blocks a launch past the wide rows takes (``launch_pair`` in
    ``csrc/ln_mlp.cu``): one for every two row tiles of ``_PAIR_ROWS``; with an odd number of
    tiles the last cluster's second tile lies past the rows."""
    return (-(-rows // _PAIR_ROWS) + 1) // 2


def _in_domain(x, w1, w2, out_dtype) -> bool:
    """K5's domain, checked before any launch: K3's for ``x`` and ``w1`` (fp32 or bf16,
    C % 32 == 0, F % 64 == 0) at K5's own widths, either 0 < C <= 256 and 0 < O <= 256 with
    O % 32 == 0, or the wide rows (:func:`_wide`, and in bf16 :func:`_pair`)."""
    c, f, o = x.shape[-1] if x.dim() else 0, w1.shape[0], w2.shape[0]
    if not ld._in_domain(x, [w1], out_dtype, _MAX_C_PAIR):
        return False
    return ((c <= _MAX_C and 0 < o <= _MAX_O and o % 32 == 0) or _wide(c, f, o)
            or _pair(c, f, o, out_dtype))


def _check(x, scale, bias, w1, b1, w2, b2, out_dtype, act):
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [..., C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be fp32 or bf16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be fp32 or bf16, got {out_dtype}")
    if act not in ld._ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    f, o = w1.shape[0], w2.shape[0]
    narrow = (c % 32 == 0 and 0 < c <= _MAX_C and f > 0 and f % 64 == 0 and o % 32 == 0
              and 0 < o <= _MAX_O)
    if rows == 0 or not (narrow or _wide(c, f, o) or _pair(c, f, o, out_dtype)):
        raise ValueError(f"the kernel takes 0 < C <= {_MAX_C} with C % 32 == 0, F % 64 == 0, "
                         f"0 < O <= {_MAX_O} with O % 32 == 0, or {_MAX_C} < C = O <= "
                         f"{_MAX_C_WIDE} (bf16 outputs: <= {_MAX_C_PAIR}) with C % 128 == 0 "
                         f"and F = 4C, and rows > 0, got x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, out {out_dtype}")
    dev = x.device
    for t, shape, what in ((scale, (c,), "LN scale"), (bias, (c,), "LN bias"),
                           (w1, (f, c), "w1"), (b1, (f,), "b1"), (w2, (o, f), "w2"),
                           (b2, (o,), "b2")):
        ld._check_param(t, shape, dev, what)
    return rows, c, f, o


def _tf32_parts(w):
    """``[2, *w.shape]``: hi = w rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, by the bits as ``ptx.cuh``'s ``round_tf32`` takes them) and lo = (w - hi) rounded
    likewise, the parts ``ln_wide.cuh``'s ``split_tf32`` gives, in fp32's layout."""
    def round_tf32(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    w = w.detach().float().contiguous()
    hi = round_tf32(w)
    return torch.stack([hi, round_tf32(w - hi)])


def _split_weight(w):
    """``w``'s TF32 parts (:func:`_tf32_parts`) for the wide rows' fp32 path, kept in
    ``_W_TF32`` and taken again while the tensor's storage and version counter are
    unchanged, as :func:`pcdiff_torch.ops.ln_dense._product_weight` keeps its bf16 copies."""
    if w.is_inference():
        return _tf32_parts(w)
    key = (w.data_ptr(), w._version)
    cached = _W_TF32.get(w)
    if cached is None or cached[0] != key:
        cached = (key, _tf32_parts(w))
        _W_TF32[w] = cached
    return cached[1]


def _launch(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
    global launches
    rows, c, f, o = _check(x, scale, bias, w1, b1, w2, b2, out_dtype, act)
    out = torch.empty(x.shape[:-1] + (o,), dtype=out_dtype, device=x.device)
    if out_dtype == torch.bfloat16:  # the kernel takes the product dtype's weights
        w1, w2 = ld._product_weight(w1), ld._product_weight(w2)
    elif _wide(c, f, o):  # and the wide rows' fp32 path their TF32 parts
        w1, w2 = _split_weight(w1), _split_weight(w2)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c, f, o, ld._ACT_CODES[act],
            float(eps), int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            _native.stream(x.device))
    if err:
        raise RuntimeError(f"ln_mlp kernel launch failed: cudaError_t {err}")
    launches += 1
    width_launches[c] = width_launches.get(c, 0) + 1
    return out


def _forward(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
    """K5 or its plain version."""
    if ld._on_card(x) and _in_domain(x, w1, w2, out_dtype):
        return _launch(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)
    return _torch_ln_mlp(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)


class _FusedLnMlp(torch.autograd.Function):
    """Forward: K5 or its plain version; saves (x, scale, bias, w1, b1, w2, b2) as the JAX
    custom VJP does. Backward: ``_mlp_bwd``'s, through K3 and K4 on the card."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
        ctx.eps, ctx.out_dtype, ctx.act = eps, out_dtype, act
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        return _forward(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2, b2 = ctx.saved_tensors
        eps, out_dtype, acts = ctx.eps, ctx.out_dtype, [ctx.act]
        g = g.to(out_dtype).contiguous()
        kernel = ld._use_bwd_kernel(x, [w1], out_dtype)  # K3's recompute and K4, or neither
        fwd = ld._launch if kernel else ld._torch_ln_denses
        (a,) = fwd(x, scale, bias, [w1], [b1], eps, out_dtype, acts)  # the recompute
        dw2, db2, g_a = _torch_ln_mlp_fc2_bwd(a, g, w2, out_dtype)
        bwd = ld._launch_bwd if kernel else ld._torch_ln_denses_bwd
        dx, dscale, dbias, (dw1,), (db1,) = bwd(x, scale, bias, [w1], [b1], [g_a], eps,
                                                out_dtype, acts)
        return (dx, dscale, dbias, dw1, db1, dw2.to(w2.dtype), db2.to(b2.dtype),
                None, None, None)


def fused_ln_mlp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 eps: float, out_dtype: torch.dtype, act=None) -> torch.Tensor:
    """``act(LN(x; scale, bias, eps) @ w1^T + b1) @ w2^T + b2`` as a ``[..., O]`` tensor in
    ``out_dtype``. ``w1 [F, C]``, ``w2 [O, F]``; both biases are required; ``act`` is None |
    'gelu' | 'gelu_tanh' | 'quick_gelu'. Differentiable in x, the LN affine, the weights and
    the biases."""
    if not _native.needs_grad(x, scale, bias, w1, b1, w2, b2):
        return _forward(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)
    return _FusedLnMlp.apply(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)
