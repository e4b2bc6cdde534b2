"""The whole pre-LN MLP in one kernel: ``act(LN(x) W1^T + b1) W2^T + b2``, with the
hidden activation never reaching device memory.

Counterpart of :func:`pcdiff.ops.ln_dense.fused_ln_mlp` and its custom VJP.
:func:`fused_ln_mlp` is a :class:`torch.autograd.Function`. On a CUDA tensor its forward
launches ``csrc/ln_mlp.cu`` (K5; it replaces the TPU kernel
``pcdiff/ops/ln_dense.py::_ln_mlp_kernel``); on a CPU tensor, or under
``set_lndense_backend("plain")`` (the switch of the LN+Dense kernels, which the JAX
package's ``use_ln_mlp`` reads too), it runs :func:`_torch_ln_mlp`, the plain version. The
backward is ``_mlp_bwd``'s: it recomputes the fc1 stage through K3
(:func:`pcdiff_torch.ops.ln_dense._launch`), takes fc2's two gradients as products in the
product dtype with fp32 accumulation (``torch.matmul``; the JAX package computes them
outside any Pallas kernel too), and the fc1 stage's gradient through K4.

Layout: ``w1 [F, C]`` and ``w2 [O, F]``, the ``nn.Linear`` layout (the JAX package's are
``[C, F]`` and ``[F, O]``), fp32, and so are their gradients. Numerics, as the TPU
kernel's: the fc1 stage is exactly :func:`pcdiff_torch.ops.ln_dense._torch_ln_denses` (its
output dtype is the product dtype: bf16 for a bf16 output, fp32 for fp32), fc2 takes
operands in the product dtype with fp32 accumulation, adds an fp32 ``b2`` and casts once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native
from . import ln_dense as ld

__all__ = ["fused_ln_mlp", "launches"]

_MAX_C = 256
_MAX_O = 256

launches = 0  # K5 launches since the last reset (chip_smoke.py resets it)
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
    if (c % 32 or not 0 < c <= _MAX_C or rows == 0 or f == 0 or f % 64 or o % 32
            or not 0 < o <= _MAX_O):
        raise ValueError(f"the kernel takes 0 < C <= {_MAX_C} with C % 32 == 0, F % 64 == 0, "
                         f"0 < O <= {_MAX_O} with O % 32 == 0 and rows > 0, got x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    dev = x.device
    for t, shape, what in ((scale, (c,), "LN scale"), (bias, (c,), "LN bias"),
                           (w1, (f, c), "w1"), (b1, (f,), "b1"), (w2, (o, f), "w2"),
                           (b2, (o,), "b2")):
        ld._check_param(t, shape, dev, what)
    return rows, c, f, o


def _launch(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
    global launches
    rows, c, f, o = _check(x, scale, bias, w1, b1, w2, b2, out_dtype, act)
    out = torch.empty(x.shape[:-1] + (o,), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c, f, o, ld._ACT_CODES[act],
            float(eps), int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ln_mlp kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


class _FusedLnMlp(torch.autograd.Function):
    """Forward: K5 or its plain version; saves (x, scale, bias, w1, b1, w2, b2) as the JAX
    custom VJP does. Backward: ``_mlp_bwd``'s, through K3 and K4 on the card."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act):
        ctx.eps, ctx.out_dtype, ctx.act = eps, out_dtype, act
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        if ld._use_kernel(x):
            return _launch(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)
        return _torch_ln_mlp(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2, b2 = ctx.saved_tensors
        eps, out_dtype, acts = ctx.eps, ctx.out_dtype, [ctx.act]
        g = g.to(out_dtype).contiguous()
        kernel = ld._use_kernel(x)
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
    return _FusedLnMlp.apply(x, scale, bias, w1, b1, w2, b2, eps, out_dtype, act)
