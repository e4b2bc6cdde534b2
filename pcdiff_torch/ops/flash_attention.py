"""Fused multi-head attention over ``[B, N, H*D]`` with the heads folded in the feature
axis, forward and backward.

Counterpart of :func:`pcdiff.ops.flash_attention.fused_attention_mh` and its custom VJP.
:func:`fused_attention_mh` is a :class:`torch.autograd.Function`. On a CUDA tensor its
forward launches ``csrc/attention_mh.cu`` (it replaces the TPU kernel
``pcdiff/ops/flash_attention.py::_mh_kernel``) and its backward launches
``csrc/attention_mh_bwd.cu`` (it replaces ``_mh_bwd_kernel``); on a CPU tensor they run
:func:`_torch_attention_mh` and :func:`_torch_attention_mh_bwd`, the plain PyTorch
versions of the same functions. The backward recomputes the softmax from the saved
``(q, k, v)``, as the JAX custom VJP does. Each kernel's note (what bounds it on the
H100, what its design does about it) is at the head of its source.

Numerics: q is pre-scaled by 1/sqrt(D). The kernels round q, k, v (and the incoming
gradient) to bf16, fp32 inputs too, as the TPU kernels do; every product accumulates in
fp32 and the softmax runs in fp32. The forward rounds the unnormalised probabilities to
bf16 for PV and divides by the fp32 row sum after it; the backward rounds the normalised
P and ds to bf16 before their products. The plain versions take that rounding as
``mxu_dtype``: bf16 for the kernels' class (and for the ``plain`` backend on a CUDA
tensor), ``q.dtype`` on the CPU, as the JAX package's XLA branch keeps fp32 operands off
the TPU, so that the fp32 model holds to the JAX model on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

__all__ = [
    "fused_attention_mh",
    "set_attention_backend",
    "launches",
    "bwd_launches",
]

_BACKEND = "kernel"  # kernel | plain
_HEAD_DIM = 32  # the kernel's head dim (the flagship's 256 / 8)

launches = 0  # forward kernel launches since the last reset (chip_smoke.py resets it)
bwd_launches = 0  # backward kernel launches, likewise
_fn = None
_bwd_fn = None


def set_attention_backend(name: str) -> None:
    """'kernel' (default) launches the CUDA kernels for CUDA tensors; 'plain' runs the
    plain PyTorch versions on every device (for comparing the two on the card)."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown attention backend {name!r}")
    _BACKEND = name


def _acc_dtype(mxu_dtype):
    """The accumulation dtype: fp32, or fp64 for fp64 operands (gradcheck)."""
    return torch.float64 if mxu_dtype == torch.float64 else torch.float32


def _heads(t, num_heads, mxu_dtype):
    """[B, N, H*D] -> [B, H, N, D], rounded to the product dtype, in the accumulation dtype."""
    b, n, hd = t.shape
    t = t.to(mxu_dtype).to(_acc_dtype(mxu_dtype))
    return t.reshape(b, n, num_heads, hd // num_heads).transpose(1, 2)


def _fold(t, like):
    """[B, H, N, D] -> [B, N, H*D] in ``like``'s dtype."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d).to(like.dtype)


def _torch_attention_mh(q, k, v, num_heads: int, mxu_dtype=torch.bfloat16):
    """Plain version of the forward kernel: per-head softmax(q k^T) v with its casts."""
    qh, kh, vh = (_heads(t, num_heads, mxu_dtype) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2))  # [B, H, Nq, Nk]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    recip = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(mxu_dtype).to(s.dtype), vh) * recip
    return _fold(o, q)


def _torch_attention_mh_bwd(q, k, v, g, num_heads: int, mxu_dtype=torch.bfloat16):
    """Plain version of the backward kernel (``_mh_bwd_kernel``): the softmax recomputed
    with the final row max, P = p / rowsum(p) in fp32, dv = P^T g, dp = g v^T,
    ds = P (dp - rowsum(dp P)), dq = ds k, dk = ds^T q; P and ds rounded to ``mxu_dtype``
    before their products. Returns (dq, dk, dv) in the dtypes of (q, k, v)."""
    qh, kh, vh, gh = (_heads(t, num_heads, mxu_dtype) for t in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    big_p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    dv = torch.matmul(big_p.to(mxu_dtype).to(s.dtype).transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = big_p * (dp - (dp * big_p).sum(dim=-1, keepdim=True))
    ds = ds.to(mxu_dtype).to(s.dtype)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return _fold(dq, q), _fold(dk, k), _fold(dv, v)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("attention_mh").pcdiff_attention_mh_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, num_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, N, H*D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share one dtype of fp32/bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    b, nq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd % num_heads or hd // num_heads != _HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {_HEAD_DIM}, got {hd}/{num_heads}")
    if b == 0 or nq == 0 or k.shape[1] == 0:
        raise ValueError("empty attention")


def _launch(q, k, v, num_heads: int):
    global launches
    _check(q, k, v, num_heads)
    b, nq, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nq, k.shape[1], num_heads, _HEAD_DIM, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_mh kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _native.library("attention_mh_bwd").pcdiff_attention_mh_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _launch_bwd(q, k, v, g, num_heads: int):
    global bwd_launches
    _check(q, k, v, num_heads)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device \
            or not g.is_contiguous():
        raise ValueError(f"the output gradient must be a contiguous {q.dtype} tensor of "
                         f"q's shape {tuple(q.shape)}, got {g.dtype} {tuple(g.shape)}")
    b, nq, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per (row, head, query): the row max, 1 / row sum and rowsum(dp P), in fp32
    stats = torch.empty(3, b * num_heads * nq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, nq, k.shape[1], num_heads, _HEAD_DIM, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_mh_bwd kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dq, dk, dv


def _plain_mxu(q):
    """The plain versions' product dtype: the kernels' bf16 on the card (the ``plain``
    backend is compared with the kernels there), q's own dtype on the CPU."""
    return torch.bfloat16 if q.device.type == "cuda" else q.dtype


def _use_kernel(q) -> bool:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")
    return q.device.type == "cuda" and _BACKEND == "kernel"


class _FusedAttentionMH(torch.autograd.Function):
    """Forward: K1 or its plain version; saves (q, k, v) as the JAX custom VJP does.
    Backward: K2 or its plain version, recomputing the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if _use_kernel(q):
            return _launch(q, k, v, num_heads)
        return _torch_attention_mh(q, k, v, num_heads, mxu_dtype=_plain_mxu(q))

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        if _use_kernel(q):
            dq, dk, dv = _launch_bwd(q, k, v, g, ctx.num_heads)
        else:
            dq, dk, dv = _torch_attention_mh_bwd(q, k, v, g, ctx.num_heads,
                                                 mxu_dtype=_plain_mxu(q))
        return dq, dk, dv, None


def fused_attention_mh(q, k, v, num_heads: int):
    """softmax(q k^T) v per head over [B, N, H*D] inputs; q pre-scaled. Returns q's dtype.
    Differentiable in q, k and v."""
    return _FusedAttentionMH.apply(q, k, v, num_heads)
