"""Fused attention: multi-head over ``[B, N, H*D]`` with the heads folded in the feature
axis (forward and backward), and over the head-split ``[B, H, N, D]`` layout (forward).

Counterpart of :func:`pcdiff.ops.flash_attention.fused_attention_mh` and its custom VJP.
:func:`fused_attention_mh` is a :class:`torch.autograd.Function`. On a CUDA tensor its
forward launches ``csrc/attention_mh.cu``, at head dim 64 ``csrc/attention_mh64.cu`` (both
replace the TPU kernel ``pcdiff/ops/flash_attention.py::_mh_kernel``) and its backward launches
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

:func:`set_attention_softmax_dtype` is the JAX package's switch of the same name (off by
default): under ``"bfloat16"`` the forward computes the exponentials as the TPU kernel's
bf16 exp panel does, t = bf16(s - rowmax(s)) with s in fp32, p = bf16(exp(t)), the row sum
of the rounded p in fp32, O = p V with bf16 operands and fp32 accumulation, out = O / l. At
head dim 32 K1 runs it in one pass over the keys where :func:`_exp_plan` splits them over
the warps of a block (every panel of the sampler and the train step), else in two sweeps; at
head dim 64 ``attention_mh64.cu`` runs it in two sweeps (the first for the row max alone);
the backward (K2) ignores the switch, as the JAX backward does.

Each kernel has a domain, a pure check of the shapes and dtypes it is built for
(:func:`_k1_domain`: head dim 32 or 64; :func:`_k2_domain`: head dim 32;
:func:`_k7_domain`: head dim 32 or 64; each within its grid's limits). A CUDA tensor
outside it takes the plain version (the backward at head dim 64: no path of the port
trains a model with it), as the JAX package
sends such shapes to XLA: K1's plain version, or under the bf16 exp switch
:func:`_torch_attention_mh_xla`, the XLA twin's numerics (the weights normalised before PV).
Nothing is caught: a kernel that fails to build or launch raises, and ``_launch`` still
refuses a shape outside its domain.

:func:`fused_attention` is the counterpart of :func:`pcdiff.ops.flash_attention.fused_attention`,
the attention behind the models' ``attention_fn`` hook. On a CUDA tensor its forward
launches ``csrc/attention.cu`` (K7; it replaces ``_attn_kernel``), on a CPU tensor it runs
:func:`_torch_attention`; its backward is the JAX package's ``_bwd`` (plain products there
too, :func:`_torch_attention_bwd`). K7 keeps the TPU kernel's numerics, which are not the
multi-head kernel's: nothing is rounded to bf16 that is not bf16 already (fp32 inputs take
fp32 products), and the weights are normalised by the fp32 row sum before they are rounded
to v's dtype for PV. :func:`set_attention_backend` governs both kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _native

__all__ = [
    "fused_attention_mh",
    "fused_attention",
    "set_attention_backend",
    "attention_backend",
    "set_attention_softmax_dtype",
    "attention_softmax_dtype",
    "launches",
    "bwd_launches",
    "k7_launches",
]

_BACKEND = "kernel"  # kernel | plain
_SOFTMAX_DTYPE = "float32"  # float32 | bfloat16: the forward's exponentials (K1)
_K1_HEAD_DIMS = (32, 64)  # K1's head dims: the flagship's 256 / 8, and Point-E's and CLIP's
_K2_HEAD_DIM = 32  # K2's head dim (the flagship's)
_EXP_HEAD_DIM = 32  # the head dim of K1's one-pass exp mode (attention_mh.cu's head dim)

launches = 0  # forward kernel launches since the last reset (chip_smoke.py resets it)
bwd_launches = 0  # backward kernel launches, likewise
k7_launches = 0  # head-split (K7) launches, likewise
_K7_HEAD_DIMS = (32, 64)  # the head dims K7 is built for
_GRID_YZ = 65535  # a grid's y and z extent: K1/K2 put heads and batch there, K7 query tiles
_K7_QUERY_TILE = 64  # queries a K7 block, as csrc/attention.cu checks its grid (BQ)
# K1's one-pass bf16 exp mode (csrc/attention_fwd.cuh exp_block): one block of at most 16
# warps a panel, in row groups of warps that split the keys, each warp holding the scores of
# at most 128 of them in registers; K and V of at most 1152 keys fit the block's shared
# memory beside the rest
_EXP_WARPS = 16
_EXP_SLICE = 128
_EXP_MAX_KEYS = 1152
# K1 at head dim 64 (csrc/attention_mh64.cu, both modes): 128 queries a block, 128-key tiles,
# and up to 4 blocks (a cluster) splitting a query tile's keys. A block's fixed work (its
# query tile, the stores) weighs ~1.6 key tiles, and a split block's cluster barriers and
# merge ~2 more (fitted to the Point-E path's panels timed with and without splits on an
# H100, default mode; the exp mode takes the same plan)
_K1_64_BQ = 128
_K1_64_BKV = 128
_K1_64_MAX_SPLITS = 4
_K1_64_FIXED = 1.6
_K1_64_MERGE = 2.0
_fn = None
_fn64 = None
_bwd_fn = None
_k7_fn = None


def set_attention_backend(name: str) -> None:
    """'kernel' (default) launches the CUDA kernels (K1, K2 and K7) for CUDA tensors;
    'plain' runs the plain PyTorch versions on every device (for comparing the two on the
    card)."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown attention backend {name!r}")
    _BACKEND = name


def attention_backend() -> str:
    return _BACKEND


def set_attention_softmax_dtype(name: str) -> None:
    """The dtype of the multi-head forward's exponentials, as
    :func:`pcdiff.ops.flash_attention.set_attention_softmax_dtype`: 'float32' (the default)
    or 'bfloat16', exp of the bf16-rounded max-subtracted scores, rounded to bf16, with the
    normalising sum and its reciprocal in fp32. Opt-in and quality-gated in the JAX package
    (row ``softmax-bf16`` of ``docs/trained_gates.json``)."""
    global _SOFTMAX_DTYPE
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown attention softmax dtype {name!r}")
    _SOFTMAX_DTYPE = name


def attention_softmax_dtype() -> str:
    return _SOFTMAX_DTYPE


def _exp_dtype():
    return torch.bfloat16 if _SOFTMAX_DTYPE == "bfloat16" else torch.float32


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


def _bf16_exp(s):
    """The bf16 exp panel: exp(bf16(s - rowmax(s))) rounded to bf16, in s's dtype."""
    return torch.exp((s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16)).to(s.dtype)


def _torch_attention_mh(q, k, v, num_heads: int, mxu_dtype=torch.bfloat16,
                        exp_dtype=torch.float32):
    """Plain version of the forward kernel: per-head softmax(q k^T) v with its casts.
    ``exp_dtype=torch.bfloat16`` is the bf16 exp mode (:func:`set_attention_softmax_dtype`):
    the row sum adds the rounded weights, and the division still comes after PV."""
    qh, kh, vh = (_heads(t, num_heads, mxu_dtype) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2))  # [B, H, Nq, Nk]
    if exp_dtype == torch.bfloat16:
        p = _bf16_exp(s)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    recip = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(mxu_dtype).to(s.dtype), vh) * recip
    return _fold(o, q)


def _torch_attention_mh_xla(q, k, v, num_heads: int, mxu_dtype):
    """The JAX package's ``_xla_attention_mh`` under the bf16 exp switch, the fallback off
    K1's domain: the bf16 exp panel, the weights normalised by their fp32 row sum and
    rounded to ``mxu_dtype`` before PV."""
    qh, kh, vh = (_heads(t, num_heads, mxu_dtype) for t in (q, k, v))
    p = _bf16_exp(torch.matmul(qh, kh.transpose(-1, -2)))
    w = p / p.sum(dim=-1, keepdim=True)
    return _fold(torch.matmul(w.to(mxu_dtype).to(p.dtype), vh), q)


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


def _exp_plan(nk: int, head_dim: int = _EXP_HEAD_DIM):
    """K1's plan for a panel of ``nk`` keys under the bf16 exp switch: ``(splits, slice)``,
    row groups of ``splits`` warps of ``slice`` keys (a multiple of 16, at most
    ``_EXP_SLICE``; the last warp takes the rest, and none is empty) that cover the panel in
    one pass: the fewest warps whose slices hold the keys (fewer warps a row trade fewer
    maxes and partials); or None past ``_EXP_MAX_KEYS`` or at another head dim than
    ``_EXP_HEAD_DIM`` (the one pass is built at D = 32 only), the two-sweep loop."""
    if nk > _EXP_MAX_KEYS or head_dim != _EXP_HEAD_DIM:
        return None
    want = -(-nk // _EXP_SLICE)
    slice_ = 16 * -(-nk // (16 * want))
    return -(-nk // slice_), slice_


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _native.library("attention_mh").pcdiff_attention_mh_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, num_heads: int, head_dims=_K1_HEAD_DIMS) -> None:
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
    if num_heads <= 0 or hd % num_heads or hd // num_heads not in head_dims:
        raise ValueError(f"the kernel takes head dims {head_dims}, got {hd}/{num_heads}")
    if b == 0 or nq == 0 or k.shape[1] == 0:
        raise ValueError("empty attention")
    if b > _GRID_YZ:
        raise ValueError(f"the kernel takes a batch of at most {_GRID_YZ}, got {b}")


def _kernel64_fn():
    global _fn64
    if _fn64 is None:
        fn = _native.library("attention_mh64").pcdiff_attention_mh64_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn64 = fn
    return _fn64


@functools.lru_cache(maxsize=None)
def _k1_64_capacity(device: int) -> tuple:
    """Clusters of 1 .. ``_K1_64_MAX_SPLITS`` blocks of the head-dim-64 kernel that CUDA
    device ``device`` runs at once (the occupancy API at the kernel's shared memory; one
    block an SM), checked against the kernel's query and key tiles."""
    fn = _native.library("attention_mh64").pcdiff_attention_mh64_tiling
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = []
    with torch.cuda.device(device):
        for splits in range(1, _K1_64_MAX_SPLITS + 1):
            clusters, bq, bkv = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = fn(splits, ctypes.byref(clusters), ctypes.byref(bq), ctypes.byref(bkv))
            if err or clusters.value < 1 or (bq.value, bkv.value) != (_K1_64_BQ, _K1_64_BKV):
                raise RuntimeError(f"attention_mh64 tiling query failed: cudaError_t {err}, "
                                   f"{clusters.value} clusters of {splits}")
            out.append(clusters.value)
    return tuple(out)


@functools.lru_cache(maxsize=1024)
def _k1_64_splits(panels: int, nq: int, nk: int, capacity: tuple) -> int:
    """How many blocks (a cluster) split each query tile's keys at head dim 64: ``panels``
    (batch rows x heads) of ``nq`` queries and ``nk`` keys, ``capacity[s - 1]`` clusters of
    s blocks at once. The count that minimises waves x (key tiles a block + its fixed work,
    ``_K1_64_FIXED`` tiles, and a split block's ``_K1_64_MERGE``), the fewest splits on a
    tie; never more than the key tiles."""
    tiles = -(-nq // _K1_64_BQ) * panels
    ntiles = -(-nk // _K1_64_BKV)
    cost = {s: -(-tiles // capacity[s - 1])
               * (-(-ntiles // s) + _K1_64_FIXED + (s > 1) * _K1_64_MERGE)
            for s in range(1, min(len(capacity), ntiles) + 1)}
    return min(cost, key=lambda s: (cost[s], s))


def _launch(q, k, v, num_heads: int, splits: int = None):
    """K1 on the card: at head dim 64 ``csrc/attention_mh64.cu`` in either mode (fp32 inputs
    first rounded to bf16 copies in a scratch tensor, by the same call), with ``splits``
    blocks a query tile (None: :func:`_k1_64_splits`' plan), else ``csrc/attention_mh.cu``.
    One count a call, whatever its launches."""
    global launches
    _check(q, k, v, num_heads)
    b, nq, hd = q.shape
    nk, d = k.shape[1], hd // num_heads
    bf16_exp = _SOFTMAX_DTYPE == "bfloat16"
    is_bf16 = int(q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        if d == 64:
            scratch = (None if is_bf16 else
                       torch.empty(q.numel() + 2 * k.numel(), dtype=torch.bfloat16,
                                   device=q.device))
            if splits is None:
                splits = _k1_64_splits(b * num_heads, nq, nk, _k1_64_capacity(q.device.index))
            err = _kernel64_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, nq, nk, num_heads,
                is_bf16, int(bf16_exp), splits, _native.stream(q.device))
        else:
            splits, slice_ = (_exp_plan(nk, d) or (0, 0)) if bf16_exp else (0, 0)
            err = _kernel_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, nq, nk, num_heads, d, is_bf16, int(bf16_exp), splits, slice_,
                _native.stream(q.device))
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
    _check(q, k, v, num_heads, (_K2_HEAD_DIM,))
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device \
            or not g.is_contiguous():
        raise ValueError(f"the output gradient must be a contiguous {q.dtype} tensor of "
                         f"q's shape {tuple(q.shape)}, got {g.dtype} {tuple(g.shape)}")
    b, nq, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # one 16-byte record per (row, head, query): the row max times log2(e), 1 / row sum and
    # rowsum(dp P), in fp32, and a pad; for fp32 inputs then the bf16 copies of q, g, k, v
    # that the kernel's first launch writes (2 bytes an element: half a float each)
    copies = 0 if q.dtype == torch.bfloat16 else q.numel() + k.numel()
    stats = torch.empty(4 * b * num_heads * nq + copies, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, nq, k.shape[1], num_heads, _K2_HEAD_DIM, int(q.dtype == torch.bfloat16),
            _native.stream(q.device))
    if err:
        raise RuntimeError(f"attention_mh_bwd kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dq, dk, dv


def _plain_mxu(q):
    """The plain versions' product dtype: the kernels' bf16 on the card (the ``plain``
    backend is compared with the kernels there), q's own dtype on the CPU."""
    return torch.bfloat16 if q.device.type == "cuda" else q.dtype


def _on_card(q) -> bool:
    """Whether the kernel backend applies to q's device (raises on a device with neither
    path)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")
    return q.device.type == "cuda" and _BACKEND == "kernel"


def _mh_domain(q, num_heads: int, head_dims) -> bool:
    hd = q.shape[-1]
    return (q.dim() == 3 and q.dtype in (torch.float32, torch.bfloat16) and q.numel() > 0
            and num_heads > 0 and hd % num_heads == 0 and hd // num_heads in head_dims
            and q.shape[0] <= _GRID_YZ)


def _k1_domain(q, num_heads: int) -> bool:
    """K1's domain, checked before any launch: [B, N, H*D] fp32 or bf16 queries with head
    dim 32 (the flagship's 256 / 8) or 64 (Point-E's and CLIP's) and a batch that fits the
    grid's z extent."""
    return _mh_domain(q, num_heads, _K1_HEAD_DIMS)


def _k2_domain(q, num_heads: int) -> bool:
    """K2's domain, checked before any launch: K1's at head dim 32 only."""
    return _mh_domain(q, num_heads, (_K2_HEAD_DIM,))


def _use_kernel(q, num_heads: int) -> bool:
    return _on_card(q) and _k1_domain(q, num_heads)


def _use_bwd_kernel(q, num_heads: int) -> bool:
    return _on_card(q) and _k2_domain(q, num_heads)


def _forward_mh(q, k, v, num_heads: int):
    """K1, its plain version, or off K1's domain under the bf16 exp switch the XLA twin's."""
    if _use_kernel(q, num_heads):
        return _launch(q, k, v, num_heads)
    if _SOFTMAX_DTYPE == "bfloat16" and not _k1_domain(q, num_heads):
        return _torch_attention_mh_xla(q, k, v, num_heads, _plain_mxu(q))
    return _torch_attention_mh(q, k, v, num_heads, mxu_dtype=_plain_mxu(q),
                               exp_dtype=_exp_dtype())


class _FusedAttentionMH(torch.autograd.Function):
    """Forward: K1 or its plain version; saves (q, k, v) as the JAX custom VJP does.
    Backward: K2 or its plain version, recomputing the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return _forward_mh(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        if _use_bwd_kernel(q, ctx.num_heads):
            dq, dk, dv = _launch_bwd(q, k, v, g, ctx.num_heads)
        else:
            dq, dk, dv = _torch_attention_mh_bwd(q, k, v, g, ctx.num_heads,
                                                 mxu_dtype=_plain_mxu(q))
        return dq, dk, dv, None


def fused_attention_mh(q, k, v, num_heads: int):
    """softmax(q k^T) v per head over [B, N, H*D] inputs; q pre-scaled. Returns q's dtype.
    Differentiable in q, k and v."""
    if not _native.needs_grad(q, k, v):
        return _forward_mh(q, k, v, num_heads)
    return _FusedAttentionMH.apply(q, k, v, num_heads)


# --------------------------------------------------------------------------------------
# Attention in the head-split [B, H, N, D] layout (K7), behind the models' attention_fn hook.
# --------------------------------------------------------------------------------------


def _torch_attention(q, k, v):
    """Plain version of K7 (``_attn_kernel``) on ``[B, H, N, D]``: fp32 scores, the softmax
    normalised by the fp32 row sum, the weights rounded to v's dtype, PV accumulated in
    fp32 and cast to q's dtype. (fp64 inputs compute in fp64, for gradcheck.)"""
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(w.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)


def _torch_attention_bwd(q, k, v, g):
    """The JAX package's ``_bwd``: the softmax recomputed in fp32 (not rounded), g, v, q and
    k upcast for the products, (dq, dk, dv) cast back to the dtypes of (q, k, v)."""
    acc = _acc_dtype(q.dtype)
    q32, k32, v32, g32 = (t.to(acc) for t in (q, k, v, g))
    w = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)), dim=-1)
    dv = torch.matmul(w.transpose(-1, -2), g32)
    dw = torch.matmul(g32, v32.transpose(-1, -2))
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _k7_kernel_fn():
    global _k7_fn
    if _k7_fn is None:
        fn = _native.library("attention").pcdiff_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _k7_fn = fn
    return _k7_fn


def _check_split(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, N, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share one dtype of fp32/bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, h, nq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in _K7_HEAD_DIMS:
        raise ValueError(f"the head-split kernel takes head dim {_K7_HEAD_DIMS}, got {d}")
    if b == 0 or h == 0 or nq == 0 or k.shape[2] == 0:
        raise ValueError("empty attention")
    if -(-nq // _K7_QUERY_TILE) > _GRID_YZ or b * h >= 2**31:
        raise ValueError(f"the head-split kernel takes at most {_K7_QUERY_TILE * _GRID_YZ} "
                         f"queries and 2^31 - 1 (batch, head) pairs, got {tuple(q.shape)}")


def _launch_split(q, k, v):
    global k7_launches
    _check_split(q, k, v)
    # the kernel takes batch, head and row strides; the D elements of a row must be
    # contiguous, as they are in the hook's transposed views
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v must have unit stride in their last dimension")
    out = torch.empty_like(q)  # q's strides: a transposed view stays one, so folding is free
    b, h, nq, d = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _k7_kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, nq, k.shape[2], d, int(q.dtype == torch.bfloat16), *strides,
            _native.stream(q.device))
    if err:
        raise RuntimeError(f"attention (head-split) kernel launch failed: cudaError_t {err}")
    k7_launches += 1
    return out


def _k7_domain(q) -> bool:
    """K7's domain, checked before any launch: [B, H, N, D] fp32 or bf16 with D = 32 or
    64, unit stride along D, and query tiles and (batch, head) pairs that fit its grid."""
    return (q.dim() == 4 and q.dtype in (torch.float32, torch.bfloat16) and q.numel() > 0
            and q.shape[-1] in _K7_HEAD_DIMS and q.stride(-1) == 1
            and -(-q.shape[2] // _K7_QUERY_TILE) <= _GRID_YZ
            and q.shape[0] * q.shape[1] < 2**31)


def _forward_split(q, k, v):
    """K7 or its plain version."""
    if _on_card(q) and _k7_domain(q):
        return _launch_split(q, k, v)
    return _torch_attention(q, k, v)


class _FusedAttention(torch.autograd.Function):
    """Forward: K7 or its plain version; saves (q, k, v) as the JAX custom VJP does.
    Backward: the JAX package's ``_bwd``, plain products on every device."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward_split(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return _torch_attention_bwd(*ctx.saved_tensors, g)


def fused_attention(q, k, v):
    """softmax(q k^T) v with an fp32 softmax over ``[B, H, N, D]`` inputs; q pre-scaled.
    Returns q's dtype. Differentiable in q, k and v."""
    if not _native.needs_grad(q, k, v):
        return _forward_split(q, k, v)
    return _FusedAttention.apply(q, k, v)
