"""Fused multi-head attention, forward, over ``[B, N, H*D]`` with the heads folded in the
feature axis.

Counterpart of :func:`pcdiff.ops.flash_attention.fused_attention_mh`. On a CUDA tensor
:func:`fused_attention_mh` launches the hand-written kernel ``csrc/attention_mh.cu``
(it replaces the TPU kernel ``pcdiff/ops/flash_attention.py::_mh_kernel``); on a CPU
tensor it runs :func:`_torch_attention_mh`, the plain PyTorch version of the same
function. The kernel's note (what bounds it on the H100, what its design does about it)
is at the head of its source.

Numerics: q is pre-scaled by 1/sqrt(D). The kernel rounds q, k and v to bf16 (fp32
inputs too, as the TPU kernel does), accumulates both products in fp32, runs the softmax
in fp32, rounds the unnormalised probabilities to bf16 for the PV product and divides by
the fp32 row sum after it. :func:`_torch_attention_mh` does the same with
``mxu_dtype=torch.bfloat16``. The CPU branch passes ``mxu_dtype=q.dtype``, as the JAX
package's XLA branch keeps fp32 operands off the TPU, so that the fp32 model holds to the
JAX model on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

__all__ = [
    "fused_attention_mh",
    "set_attention_backend",
    "launches",
]

_BACKEND = "kernel"  # kernel | plain
_HEAD_DIM = 32  # the kernel's head dim (the flagship's 256 / 8)

launches = 0  # kernel launches since the last reset (chip_smoke.py resets it)
_fn = None


def set_attention_backend(name: str) -> None:
    """'kernel' (default) launches the CUDA kernel for CUDA tensors; 'plain' runs the plain
    PyTorch version on every device (for comparing the two on the card)."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown attention backend {name!r}")
    _BACKEND = name


def _torch_attention_mh(q, k, v, num_heads: int, mxu_dtype=torch.bfloat16):
    """Plain version of the kernel: per-head softmax(q k^T) v with the kernel's casts."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    d = hd // num_heads

    def heads(t, n):  # [B, N, H*D] -> [B, H, N, D], rounded to the product dtype
        return t.to(mxu_dtype).float().reshape(b, n, num_heads, d).transpose(1, 2)

    s = torch.matmul(heads(q, nq), heads(k, nk).transpose(-1, -2))  # fp32 [B, H, Nq, Nk]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    recip = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(mxu_dtype).float(), heads(v, nk)) * recip
    return o.transpose(1, 2).reshape(b, nq, hd).to(q.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("attention_mh").pcdiff_attention_mh_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, num_heads: int):
    global launches
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


def fused_attention_mh(q, k, v, num_heads: int):
    """softmax(q k^T) v per head over [B, N, H*D] inputs; q pre-scaled. Returns q's dtype."""
    if q.device.type == "cuda" and _BACKEND == "kernel":
        return _launch(q, k, v, num_heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")
    return _torch_attention_mh(q, k, v, num_heads, mxu_dtype=q.dtype)
