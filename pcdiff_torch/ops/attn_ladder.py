"""The multi-head attention kernel cut off stage by stage: a profiling ladder (K8).

Counterpart of ``scripts/attn_profile.py::_ladder_kernel``, the ablation of the TPU's
``_mh_kernel``. :func:`ladder` launches ``csrc/attention_ladder.cu`` on a CUDA tensor and
runs :func:`_torch_ladder`, its plain version, on a CPU tensor (or under
``set_attention_backend("plain")``). Each rung is the loop of the port's multi-head kernel
(K1, ``csrc/attention_mh.cu``) up to one stage and writes, per head into that head's D
columns of a bf16 ``[B, Nq, H*D]`` output:

- ``qk``: the first D key columns of S = Q K^T;
- ``qk_max``: rowmax(S), broadcast;
- ``qk_exp``: exp(S[:, :D] - rowmax(S));
- ``qk_sum``: the row sum of exp(S - rowmax(S)), broadcast;
- ``nomax``: (exp(S) V) / rowsum(exp(S)), the full kernel without its max.

The full kernel is :func:`pcdiff_torch.ops.flash_attention.fused_attention_mh` itself.
Operands are rounded to bf16 and the products accumulate in fp32, as in K1.
:mod:`pcdiff_torch.scripts.attn_profile` times the rungs on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native
from . import flash_attention as fa

__all__ = ["ladder", "RUNGS", "launches"]

RUNGS = ("qk", "qk_max", "qk_exp", "qk_sum", "nomax")
_HEAD_DIM = 32  # the kernel's head dim, K1's

launches = 0  # K8 launches since the last reset (chip_smoke.py resets it)
_fn = None


def _torch_ladder(q, k, v, num_heads: int, rung: str):
    """Plain version of every rung on ``[B, N, H*D]`` inputs; bf16 ``[B, Nq, H*D]`` out."""
    if rung not in RUNGS:
        raise ValueError(f"unknown rung {rung!r}")
    qh, kh, vh = (fa._heads(t, num_heads, torch.bfloat16) for t in (q, k, v))
    d = qh.shape[-1]
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if rung == "nomax":
        p = torch.exp(s)
        o = torch.matmul(p.to(torch.bfloat16).to(s.dtype), vh) * (1.0 / p.sum(-1, keepdim=True))
    elif rung == "qk":
        o = s[..., :d]
    else:
        m = s.amax(dim=-1, keepdim=True)
        if rung == "qk_max":
            o = m.expand(*m.shape[:-1], d)
        elif rung == "qk_exp":
            o = torch.exp(s[..., :d] - m)
        else:
            r = torch.exp(s - m).sum(dim=-1, keepdim=True)
            o = r.expand(*r.shape[:-1], d)
    b, h, nq, _ = o.shape
    return o.transpose(1, 2).reshape(b, nq, h * d).to(torch.bfloat16)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("attention_ladder").pcdiff_attention_ladder
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, num_heads: int, rung: str):
    global launches
    fa._check(q, k, v, num_heads, (_HEAD_DIM,))
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the ladder kernel takes bf16 inputs, got {q.dtype}")
    if rung not in RUNGS:
        raise ValueError(f"unknown rung {rung!r}")
    if k.shape[1] < _HEAD_DIM:
        raise ValueError(f"the ladder writes the first {_HEAD_DIM} key columns: needs "
                         f"Nk >= {_HEAD_DIM}, got {k.shape[1]}")
    b, nq, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, k.shape[1],
            num_heads, _HEAD_DIM, RUNGS.index(rung), _native.stream(q.device))
    if err:
        raise RuntimeError(f"attention_ladder kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def ladder(q, k, v, num_heads: int, rung: str):
    """One rung of the ladder on ``[B, N, H*D]`` inputs (q pre-scaled); bf16 output."""
    if fa._on_card(q) and fa._mh_domain(q, num_heads, (_HEAD_DIM,)):
        return _launch(q, k, v, num_heads, rung)
    return _torch_ladder(q, k, v, num_heads, rung)
