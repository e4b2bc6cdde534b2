"""Standalone LayerNorm over the last axis, forward and backward.

Counterpart of :func:`pcdiff.ops.layer_norm.fused_layer_norm` and its custom VJP:
:func:`fused_layer_norm` is a :class:`torch.autograd.Function` whose forward saves
``(x, scale, bias)``. Numerics, as the JAX package's: fp32 statistics with the
fast-variance formula ``max(0, E[x^2] - E[x]^2)`` (not torch's two-pass variance), fp32
scale and bias, one cast to ``out_dtype``; the backward's dx in x's dtype, dscale and dbias
summed over all rows in fp32.

Backends (:func:`set_layernorm_backend`), as the JAX package's ``auto | pallas | xla``:

- ``"auto"`` (the default) runs the plain composition, :func:`layer_norm` and
  :func:`_torch_layer_norm_bwd`, on every device. It is the counterpart of the JAX
  package's default XLA LayerNorm (``_use_pallas_ln`` keeps XLA unless asked), not a
  fallback.
- ``"kernel"`` launches ``csrc/layer_norm.cu`` for CUDA tensors: K6a forward (it replaces
  the TPU kernel ``pcdiff/ops/layer_norm.py::_ln_fwd_kernel``) and K6b backward (it
  replaces ``_ln_bwd_kernel``), for the shapes and dtypes the JAX package sends to its
  kernel (``C % 128 == 0``, ``C <= 4096``, fp32, bf16 or fp16); the others run the plain
  composition there as they run XLA in the JAX package. A CPU tensor runs the plain
  versions.
- ``"plain"`` forces the plain versions on every device, for comparisons.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _native

__all__ = [
    "fused_layer_norm",
    "layer_norm",
    "set_layernorm_backend",
    "layernorm_backend",
    "launches",
    "bwd_launches",
]

_BACKEND = "auto"  # auto | kernel | plain
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_C = 4096
# K6b's first pass (csrc/layer_norm.cu): rows of at most REG_C columns are held in registers by
# a grid sized to the card, _BWD_PER_SM blocks an SM of _BWD_WARPS warps, a row a warp at a
# time; wider rows take one block per BWD_ROWS rows
_REG_C = 256
_BWD_WARPS = 8
_BWD_PER_SM = 2
_BWD_ROWS = 64

launches = 0  # K6a launches since the last reset (chip_smoke.py resets it)
bwd_launches = 0  # K6b launches, likewise
_fns: dict = {}


def set_layernorm_backend(name: str) -> None:
    """'auto' (default: the plain composition), 'kernel' (K6a/K6b for CUDA tensors the JAX
    package would send to its kernel) or 'plain' (the plain versions everywhere)."""
    global _BACKEND
    if name not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown LayerNorm backend {name!r}")
    _BACKEND = name


def layernorm_backend() -> str:
    return _BACKEND


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def layer_norm(x, scale, bias, epsilon: float, out_dtype):
    """Plain version of K6a (``_xla_layer_norm``): fp32 statistics (fp64 for fp64 input)."""
    acc = _acc_dtype(x)
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + epsilon) * scale.to(acc)
    return ((x32 - mean) * mul + bias.to(acc)).to(out_dtype)


def _torch_layer_norm_bwd(x, scale, g, epsilon: float):
    """Plain version of K6b (``_xla_layer_norm_bwd``): (dx, dscale, dbias) in fp32 (fp64
    for fp64 input), the parameter gradients summed over all rows."""
    acc = _acc_dtype(x)
    x32, g32 = x.to(acc), g.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    inv = torch.rsqrt(var + epsilon)
    xhat = (x32 - mean) * inv
    gs = g32 * scale.to(acc)
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (gs - m1 - xhat * m2)
    c = x.shape[-1]
    return dx, (g32 * xhat).reshape(-1, c).sum(dim=0), g32.reshape(-1, c).sum(dim=0)


def _use_kernel(x, *dtypes) -> bool:
    """The JAX package's ``_use_pallas_ln`` gate, for CUDA tensors under 'kernel'."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LayerNorm path for device {x.device}")
    if _BACKEND != "kernel" or x.device.type != "cuda":
        return False
    c = x.shape[-1]
    if c == 0 or c % 128 or c > _MAX_C or x.numel() == 0:
        return False
    return all(d in _DTYPE_CODES for d in (x.dtype, *dtypes))


def _kernel_fn(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_native.library("layer_norm"), name)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "pcdiff_layer_norm_fwd":
            fn.argtypes = [vp] * 4 + [i32, i32, ctypes.c_float, i32, i32, vp]
        else:  # the backward also takes its first pass's grid
            fn.argtypes = [vp] * 7 + [i32, i32, i32, ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(x, *params):
    """(rows, C) of ``x``; raises on what the kernels do not take (the 4-element vector
    accesses need 16-byte aligned rows)."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned [..., C] tensor")
    c = x.shape[-1]
    for t in params:
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device
                or tuple(t.shape) != (c,)):
            raise ValueError(f"the LN scale and bias must be contiguous fp32 [{c}] tensors "
                             f"on {x.device}")
    return x.numel() // c, c


def _launch(x, scale, bias, eps, out_dtype):
    global launches
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel writes fp32, bf16 or fp16, not {out_dtype}")
    rows, c = _check(x, scale, bias)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn("pcdiff_layer_norm_fwd")(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c,
            float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
            _native.stream(x.device))
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError_t {err}")
    launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_blocks(rows: int, c: int, sms: int) -> int:
    """K6b's first-pass grid, and so the number of partials its second pass sums: past
    ``_REG_C`` one block per ``_BWD_ROWS`` rows; else ``_BWD_PER_SM`` blocks an SM of the
    ``sms``, and no more blocks than there are rows for their warps."""
    if c > _REG_C:
        return -(-rows // _BWD_ROWS)
    return min(-(-rows // _BWD_WARPS), _BWD_PER_SM * sms)


def _launch_bwd(x, scale, g, eps):
    """K6b: (dx in x's dtype, dscale fp32, dbias fp32)."""
    global bwd_launches
    rows, c = _check(x, scale)
    if g.shape != x.shape or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"g must be a contiguous, 16-byte aligned {tuple(x.shape)} tensor")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    blocks = _bwd_blocks(rows, c, _sms(x.device.index))
    part = torch.empty(2, blocks, c, **f32)
    with torch.cuda.device(x.device):
        err = _kernel_fn("pcdiff_layer_norm_bwd")(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), part.data_ptr(), blocks, rows, c, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[g.dtype], _native.stream(x.device))
    if err:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dx, dscale, dbias


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: K6a or its plain version; saves (x, scale, bias) as the JAX custom VJP
    does. Backward: K6b or its plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        if _use_kernel(x):
            return _launch(x, scale, bias, eps, out_dtype)
        return layer_norm(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        g = g.contiguous()
        if _use_kernel(x, g.dtype):
            dx, dscale, dbias = _launch_bwd(x, scale, g, ctx.eps)
        else:
            dx, dscale, dbias = _torch_layer_norm_bwd(x, scale, g, ctx.eps)
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     epsilon: float, out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of ``x [..., C]`` over its last axis with ``scale``, ``bias [C]``, in
    ``out_dtype``. Differentiable in x, scale and bias."""
    return _FusedLayerNorm.apply(x, scale, bias, epsilon, out_dtype)
