"""Fused LayerNorm -> projection(s), forward: ``[act_i(LN(x) W_i^T + b_i)]`` without the
normalised tensor ever reaching device memory.

Counterpart of :func:`pcdiff.ops.ln_dense.fused_ln_denses`. On a CUDA tensor
:func:`fused_ln_denses` launches the hand-written kernel ``csrc/ln_dense.cu`` (it
replaces the TPU kernel ``pcdiff/ops/ln_dense.py::_ln_denses_kernel``); on a CPU tensor
it runs :func:`_torch_ln_denses`, the plain PyTorch version of the same function. The
kernel's note (what bounds it on the H100, what its design does about it) is at the head
of its source.

Layout: the weights are in the ``nn.Linear`` layout ``[F_i, C]`` (the JAX package's
kernels are ``[C, F_i]``). Numerics, as the TPU kernel's: fp32 fast-variance LN
statistics and fp32 affine, the normalised rows cast to the product dtype (bf16 when the
output is bf16, fp32 when it is fp32), fp32 accumulation, bias and activation on the
fp32 accumulator, one cast out. ``gelu`` is the exact-erf form through ``_erf_f32``,
XLA's erf rational that the TPU kernel reproduces.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _native

__all__ = [
    "fused_ln_denses",
    "set_lndense_backend",
    "launches",
]

_BACKEND = "kernel"  # kernel | plain
_ACT_CODES = {None: 0, "gelu": 1, "gelu_tanh": 2, "quick_gelu": 3}
_MAX_C = 256
_TILE_F = 64

launches = 0  # kernel launches since the last reset (chip_smoke.py resets it)
_fn = None

# XLA's f32 erf rational (xla/client/lib/math.cc ErfImpl32), as pcdiff/ops/ln_dense.py.
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def set_lndense_backend(name: str) -> None:
    """'kernel' (default) launches the CUDA kernel for CUDA tensors; 'plain' runs the plain
    PyTorch version on every device (for comparing the two on the card)."""
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


def _product_dtype(out_dtype):
    return torch.float32 if out_dtype == torch.float32 else torch.bfloat16


def _torch_ln_denses(x, scale, bias, weights, biases, eps, out_dtype, acts):
    """Plain version of the kernel, with its dtype casts."""
    mxu = _product_dtype(out_dtype)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = (y * scale.float() + bias.float()).to(mxu).float()
    outs = []
    for w, b, act in zip(weights, biases, acts):
        o32 = torch.matmul(y, w.to(mxu).float().t())
        if b is not None:
            o32 = o32 + b.float()
        outs.append(_apply_act(o32, act).to(out_dtype))
    return outs


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("ln_dense").pcdiff_ln_denses_fwd
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ptrs, ptrs, ptrs, ints, ints,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_param(t, shape, device, what):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what} must be a contiguous fp32 tensor on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")


def _launch(x, scale, bias, weights, biases, eps, out_dtype, acts):
    global launches
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
    if c % 32 or not 0 < c <= _MAX_C or rows == 0:
        raise ValueError(f"the kernel takes 0 < C <= {_MAX_C} with C % 32 == 0 and rows > 0, "
                         f"got x {tuple(x.shape)}")
    if any(a not in _ACT_CODES for a in acts):
        raise ValueError(f"unknown activation in {acts!r}")
    dev = x.device
    _check_param(scale, (c,), dev, "LN scale")
    _check_param(bias, (c,), dev, "LN bias")
    outs = []
    for i, (w, b) in enumerate(zip(weights, biases)):
        f = w.shape[0]
        if f == 0 or f % _TILE_F:
            raise ValueError(f"the kernel takes F % {_TILE_F} == 0, got weight {tuple(w.shape)}")
        _check_param(w, (f, c), dev, f"weight {i}")
        if b is not None:
            _check_param(b, (f,), dev, f"bias {i}")
        outs.append(torch.empty(x.shape[:-1] + (f,), dtype=out_dtype, device=dev))
    vp = ctypes.c_void_p * 3
    ci = ctypes.c_int * 3
    pad = [None] * (3 - n)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n,
            vp(*[w.data_ptr() for w in weights], *pad),
            vp(*[None if b is None else b.data_ptr() for b in biases], *pad),
            vp(*[o.data_ptr() for o in outs], *pad),
            ci(*[w.shape[0] for w in weights], *([0] * (3 - n))),
            ci(*[_ACT_CODES[a] for a in acts], *([0] * (3 - n))),
            rows, c, float(eps), int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ln_dense kernel launch failed: cudaError_t {err}")
    launches += 1
    return outs


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
    ``acts`` entries are None | 'gelu' | 'gelu_tanh' | 'quick_gelu'."""
    weights, biases = tuple(weights), tuple(biases)
    acts = (None,) * len(weights) if acts is None else tuple(acts)
    if x.device.type == "cuda" and _BACKEND == "kernel":
        return _launch(x, scale, bias, weights, biases, eps, out_dtype, acts)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LN+Dense path for device {x.device}")
    return _torch_ln_denses(x, scale, bias, weights, biases, eps, out_dtype, acts)
