"""The CUDA sources of the port and their build rule, on the CPU (no nvcc).

- ``_native.stale``: a library is rebuilt when its source or a header is newer, and only
  then, so an edit to ``csrc/attention_fwd.cuh`` rebuilds the three libraries that include it.
- The attention sources: K1 (``attention_mh.cu``), K7 (``attention.cu``) and the ladder K8
  (``attention_ladder.cu``) include the one bf16 loop of ``attention_fwd.cuh``; neither K1 nor
  the ladder has a key loop of its own, and K7's own loop belongs to its fp32 kernel alone:
  one pass over the keys on ``ptx.cuh``'s TF32 ``mma.sync`` (3xTF32), with no bf16.
  The backward K2 (``attention_mh_bwd.cu``) is built on the same primitives of ``ptx.cuh``
  (``mma.sync``, ``ldmatrix``, ``cp.async``, ``ex2.approx``), with no WMMA and no atomics.
- K1's one-pass bf16 exp mode and ``fa._exp_plan`` agree on its warps, the keys a warp holds
  and the longest panel it takes; the cuts of its profiling script (``scripts/exp_cuts.py``)
  still apply to its source.
- The whole-MLP kernel K5 (``ln_mlp.cu``) is built on K3's loop (``ln_dense_fwd.cuh``) and
  ``ptx.cuh``: ``wgmma`` for its bf16 products, K3's FMA stage for its fp32 ones, no WMMA;
  the cuts of its profiling script (``scripts/mlp_cuts.py``) still apply to its source.
- K7's fp32 path: the cuts and variants of its profiling script (``scripts/k7_cuts.py``) still
  apply to its source.
- K6b (``layer_norm.cu``): the wrapper plans its first pass with the kernel's constants, a
  grid of at most two blocks an SM that gives every warp a row, and no atomics.
- K4's bf16 path (``ln_dense_bwd.cu``) has no WMMA, atomics or TF32: K3's bf16 block with
  K4's epilogue, and dy and dW on ``ptx.cuh``'s ``wgmma`` with shared-memory operands; the
  cuts of its profiling script (``scripts/ln_bwd_cuts.py``) still apply to its source.
"""

import os
import re

import pytest

from pcdiff_torch.ops import _native
from pcdiff_torch.scripts import exp_cuts, k7_cuts, ln_bwd_cuts, mlp_cuts

ATTENTION_SOURCES = ("attention_mh", "attention", "attention_ladder")
# a loop bounded by the key count (the K/V tile loop of an attention kernel)
KEY_LOOP = re.compile(r"\bfor\s*\([^;]*;[^;]*\bnk\b")


def _touch(path, mtime):
    path.write_text("// source\n")
    os.utime(path, (mtime, mtime))


@pytest.mark.parametrize("header_age,want", [(+10, True), (-10, False)])
def test_header_newer_than_library_makes_it_stale(tmp_path, header_age, want):
    lib, src, header = tmp_path / "libk.so", tmp_path / "k.cu", tmp_path / "loop.cuh"
    _touch(src, 1_000_000)
    _touch(lib, 1_000_100)
    _touch(header, 1_000_100 + header_age)
    assert _native.stale(lib, [src, header]) is want


def test_missing_library_or_newer_source_is_stale(tmp_path):
    lib, src = tmp_path / "libk.so", tmp_path / "k.cu"
    _touch(src, 1_000_000)
    assert _native.stale(lib, [src])
    _touch(lib, 999_000)
    assert _native.stale(lib, [src])
    _touch(lib, 1_000_000)
    assert not _native.stale(lib, [src])


@pytest.mark.parametrize("name", ATTENTION_SOURCES)
def test_attention_sources_share_one_loop(name):
    text = (_native.CSRC_DIR / f"{name}.cu").read_text()
    assert '#include "attention_fwd.cuh"' in text
    assert (_native.CSRC_DIR / "attention_fwd.cuh").exists()
    loops = [m.start() for m in KEY_LOOP.finditer(text)]
    if name != "attention":
        assert loops == [], f"{name}.cu has a key loop of its own"
        return
    # K7 keeps one loop of its own, its fp32 kernel's single pass over the keys, in that
    # kernel's body; the fp32 path runs on TF32 mma.sync and the rounding to TF32 (3xTF32)
    # and touches no bf16, while the bf16 kernel stays on the shared loop's NORMALISED mode
    start = text.index("head_split_attention_fp32_kernel(const Args a)")
    end = text.index("\n}\n", start)
    assert len(loops) == 1 and start < loops[0] < end
    fp32 = text[text.index("// ---- fp32:"):text.index("int launch_fp32(")]
    code = re.sub(r"//[^\n]*", "", fp32)
    assert "mma_tf32(" in code and "round_tf32(" in code
    assert "bf16" not in fp32
    assert "attention_block<pcdiff_attn::NORMALISED" in text


def test_header_holds_the_bf16_key_loop():
    text = (_native.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert re.search(r"for \(int t = 0; t < ntiles; \+\+t\)", text)
    # the PTX primitives the loop is built from live in ptx.cuh, which the header includes
    assert '#include "ptx.cuh"' in text
    text += (_native.CSRC_DIR / "ptx.cuh").read_text()
    for op in ("mma.sync.aligned.m16n8k16", "ldmatrix", "cp.async.cg", "ex2.approx"):
        assert op in text, op
    # and the TF32 product of K7's fp32 kernel, and its rounding to TF32: cvt.rna.tf32.f32's
    # bits for finite inputs, by two integer operations
    assert re.search(r"mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32\.tf32\.f32", text)
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in text


def test_attention_backward_builds_on_ptx_primitives():
    text = (_native.CSRC_DIR / "attention_mh_bwd.cu").read_text()
    assert '#include "attention_fwd.cuh"' in text  # its staging, whose header includes ptx.cuh
    code = re.sub(r"//[^\n]*", "", text)  # the code, without its comments
    for call in ("mma_bf16(", "ldmatrix_x4(", "ldmatrix_x4_trans(", "cp_async_16(",
                 "cp_async_commit(", "cp_async_wait<", "ex2("):
        assert call in code, call
    # no WMMA (whose fragments round-trip through shared memory), no atomics, no accurate expf
    for banned in ("wmma", "<mma.h>", "store_matrix_sync", "atomic", "expf("):
        assert banned not in code, banned


def test_exp_plan_matches_the_one_pass_kernel():
    """``fa._exp_plan`` plans with the one-pass kernel's warps, keys a warp and panel length."""
    from pcdiff_torch.ops import flash_attention as fa

    text = (_native.CSRC_DIR / "attention_fwd.cuh").read_text()
    for name, want in (("EXP_WARPS", fa._EXP_WARPS), ("EXP_SLICE", fa._EXP_SLICE),
                       ("EXP_MAX_KEYS", fa._EXP_MAX_KEYS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == want, name
    assert "exp_block<D>(p, splits, slice, smem)" in (
        _native.CSRC_DIR / "attention_mh.cu").read_text()


def test_ln_dense_grid_is_one_dimensional():
    """K3 numbers its blocks (row tile, column group) along x alone, so no grid extent of
    65535 bounds the rows it takes; its wrapper asks the library for the tiling."""
    text = "".join((_native.CSRC_DIR / n).read_text() for n in ("ln_dense.cu", "ln_dense_fwd.cuh"))
    assert "blockIdx.y" not in text and "blockIdx.z" not in text and "dim3" not in text
    assert "pcdiff_ln_denses_tiling" in text


def test_whole_mlp_kernel_builds_on_the_ln_dense_loop():
    text = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    assert '#include "ln_dense_fwd.cuh"' in text and '#include "ptx.cuh"' in text
    code = re.sub(r"//[^\n]*", "", text)  # the code, without its comments
    # bf16: the panel and epilogue of K3's loop, wgmma from shared memory (fc1) and from
    # registers (fc2), weights by the TMA; fp32: K3's FMA stage
    for call in ("panel_start<", "epilogue_bf16<", "wgmma_m64n64k16(", "wgmma_m64n256k16_rs(",
                 "tma_load_2d(", "fma_stage_fp32<"):
        assert call in code, call
    for banned in ("<mma.h>", "wmma::", "wmma", "tf32"):
        assert banned not in code, banned
    ptx = (_native.CSRC_DIR / "ptx.cuh").read_text()
    for op in ("wgmma.mma_async.sync.aligned.m64n256k16", "cp.async.bulk.tensor.2d",
               "mbarrier.try_wait.parity", "setmaxnreg"):
        assert op in ptx, op
    # the exhaustive check of its fast division compares it with __fdiv_rn's
    check = (_native.CSRC_DIR / "act_check.cu").read_text()
    assert "DivFast{ok}" in check and "DivRn()" in check and "1ull << 32" in check


def test_ln_backward_builds_on_the_ln_dense_loop():
    """K4's fp32 path: K3's fp32 block with its own epilogue (act' specialised by activation,
    on the fast division), and dy and dW on the header's FMA stage with K-major operands,
    streamed by cp.async; partial sums added in a fixed order, with no atomics."""
    text = (_native.CSRC_DIR / "ln_dense_bwd.cu").read_text()
    assert '#include "ln_dense_fwd.cuh"' in text and '#include "ptx.cuh"' in text
    code = re.sub(r"//[^\n]*", "", text)
    for call in ("block_fp32<TX>(", "act_grad<ACT>(", "DivFast{ok}", "cp_async_16(",
                 "fma_stage_fp32<2, pcdiff_ln::K_CONTIG, pcdiff_ln::K_MAJOR>(",
                 "fma_stage_fp32<2, pcdiff_ln::K_MAJOR, pcdiff_ln::K_MAJOR>("):
        assert call in code, call
    for banned in ("atomic", "tf32"):
        assert banned not in code.lower(), banned
    # every kernel's name holds ln_denses_bwd, so the profile counts it as K4's (none as K3's)
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", code)
    assert len(kernels) == 8 and all("ln_denses_bwd" in k and "ln_denses_kernel" not in k
                                     for k in kernels), kernels
    check = (_native.CSRC_DIR / "act_check.cu").read_text()
    assert "act_grad<ACT>(v, pcdiff_ln::DivFast{ok})" in check


def test_ln_backward_bf16_path_builds_on_wgmma():
    """K4's bf16 path: no WMMA, no atomics, no TF32; K3's bf16 block with K4's epilogue (act'
    on the fast division with its round-to-nearest retake), and dy and dW on ptx.cuh's wgmma
    with both operands in shared memory, W's and y's rows (and dW's gz) MN-major."""
    text = (_native.CSRC_DIR / "ln_dense_bwd.cu").read_text()
    code = re.sub(r"//[^\n]*", "", text)
    for banned in ("<mma.h>", "wmma", "atomic", "tf32", "store_matrix_sync"):
        assert banned not in code.lower(), banned
    bf16 = code[code.index("namespace bf16_path"):code.index("bool aligned16(")]
    for call in ("pcdiff_ln::block_bf16<TX>(", "DivFast{ok}", "DivRn()",
                 "wgmma_m64n256k16_ss<0, 1>(", "wgmma_m64n256k16_ss<1, 1>(", "sw128_desc(",
                 "sw128_desc_mn(", "wgmma_commit()", "wgmma_wait<0>()", "cp_async_16("):
        assert call in bf16, call
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", bf16)
    assert kernels == ["ln_denses_bwd_gz_bf16_kernel", "ln_denses_bwd_dy_bf16_kernel",
                       "ln_denses_bwd_dw_bf16_kernel"], kernels
    ptx = (_native.CSRC_DIR / "ptx.cuh").read_text()
    wrapper = ptx[ptx.index("wgmma_m64n256k16_ss("):]
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in wrapper
    assert '"n"(TRANS_A), "n"(TRANS_B)' in wrapper  # the transpose bits are immediates


@pytest.mark.parametrize("cut", list(mlp_cuts.CUTS), ids=" / ".join)
def test_mlp_cuts_apply_to_the_kernel_source(cut):
    text = mlp_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "ln_mlp.cu").read_text()


@pytest.mark.parametrize("cut", list(ln_bwd_cuts.CUTS))
def test_ln_bwd_cuts_apply_to_the_kernel_source(cut):
    text = ln_bwd_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "ln_dense_bwd.cu").read_text()


@pytest.mark.parametrize("cut", list(exp_cuts.CUTS))
def test_exp_cuts_apply_to_the_kernel_source(cut):
    text = exp_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert "exp_block" in text


@pytest.mark.parametrize("cut", list(k7_cuts.CUTS))
def test_k7_cuts_apply_to_the_kernel_source(cut):
    text = k7_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "attention.cu").read_text()
    assert "head_split_attention_fp32_kernel" in text


def test_layer_norm_bwd_plan_matches_the_kernel():
    """``_bwd_blocks`` plans K6b's first pass with the kernel's constants: rows of at most
    REG_C columns in registers on a grid sized to the card (at every standalone LayerNorm of
    the fully fused train step, at most two blocks an SM of 132 and no warp without a row),
    wider rows one block per BWD_ROWS rows; the passes use no atomics."""
    from pcdiff_torch.ops import layer_norm as lnorm

    text = (_native.CSRC_DIR / "layer_norm.cu").read_text()
    for name, want in (("REG_C", lnorm._REG_C), ("BWD_ROWS", lnorm._BWD_ROWS),
                       ("THREADS", 32 * lnorm._BWD_WARPS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == want, name
    assert "atomic" not in re.sub(r"//[^\n]*", "", text)
    for rows in (32, 4096, 8192, 20576, 32768):  # the class/view norms, encoders, z and x
        blocks = lnorm._bwd_blocks(rows, 256, 132)
        assert 1 <= blocks <= lnorm._BWD_PER_SM * 132
        assert blocks * lnorm._BWD_WARPS <= rows  # every warp of the grid has a row
    assert lnorm._bwd_blocks(1000, 512, 132) == -(-1000 // lnorm._BWD_ROWS)
