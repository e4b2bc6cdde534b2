"""The CUDA sources of the port and their build rule, on the CPU (no nvcc).

- ``_native.stale``: a library is rebuilt when its source or a header is newer, and only
  then, so an edit to ``csrc/attention_fwd.cuh`` rebuilds the three libraries that include it.
  Two processes that reach a stale library at once build it once: one builds under the
  build directory's file lock, the other waits and loads its library.
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
- The Point-E path's kernels: K1 at head dim 64 (``attention_mh64.cu``) and K3's wide rows
  (``ln_dense.cu`` namespace ``wide``) are built on ``wgmma``, the TMA and mbarrier rings (K3's
  fp32 path on 3xTF32); the flagship's loops beside them are unchanged byte for byte; their
  panels and rings fit an SM's shared memory; ``fa._k1_64_splits`` plans with the kernel's
  constants; the cuts of ``scripts/k3_wide_cuts.py`` still apply.
"""

import os
import re

import pytest

from pcdiff_torch.ops import _native
from pcdiff_torch.scripts import exp_cuts, k3_wide_cuts, k7_cuts, ln_bwd_cuts, mlp_cuts

ATTENTION_SOURCES = ("attention_mh", "attention", "attention_ladder")
# a loop bounded by the key count (the K/V tile loop of an attention kernel)
KEY_LOOP = re.compile(r"\bfor\s*\([^;]*;[^;]*\bnk\b")


STUB_COMPILER = """#!/usr/bin/env python3
import subprocess, sys, time
args = sys.argv[1:]
with open(sys.argv[0] + ".builds", "a") as f:
    f.write("build\\n")
time.sleep(1.0)  # long enough for the other process to reach the library
out = args[args.index("-o") + 1]
subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "-o", out, args[-1]], check=True)
"""


def _load_stub(csrc, build, compiler, loaded):
    """In a process of its own: ``library("stub")`` from ``csrc`` into ``build`` with the
    stub compiler (it counts its builds, then builds with g++); writes what the loaded
    library returns."""
    from pathlib import Path

    _native.CSRC_DIR, _native.BUILD_DIR = Path(csrc), Path(build)
    _native._nvcc = lambda: compiler
    lib = _native.library("stub")
    with open(loaded, "w") as f:
        f.write(str(lib.stub_answer()))


def test_two_processes_build_a_stale_library_once(tmp_path):
    import multiprocessing
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("the stub compiler builds with g++")
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "stub.cu").write_text('extern "C" int stub_answer() { return 42; }\n')
    compiler = tmp_path / "nvcc"
    compiler.write_text(STUB_COMPILER)
    compiler.chmod(0o755)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_load_stub, args=(str(csrc), str(build), str(compiler),
                                                  str(tmp_path / f"loaded{i}")))
             for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0, 0]
    assert (tmp_path / "nvcc.builds").read_text().splitlines() == ["build"]
    assert [(tmp_path / f"loaded{i}").read_text() for i in range(2)] == ["42", "42"]


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
    """K5's narrow paths (C, O <= 256) on K3's loop: bf16 wgmma with h from registers, fp32
    on K3's FMA stage, no TF32. Its wide rows (namespace ``wide``, Point-E's C = O = 512) on
    K3-wide's panel (``ln_wide.cuh``): bf16 wgmma (fc1 from the panel, fc2 with h from
    shared memory, the exact GELU on FMAs), the weights by the TMA through an mbarrier ring,
    the fp32 products in 3xTF32 only (every TF32 product through ``mma_3xtf32``) on weights
    split into their TF32 parts once, by the wrapper, not by the warps; no atomics."""
    text = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    for header in ("ln_dense_fwd.cuh", "ln_wide.cuh", "ptx.cuh"):
        assert f'#include "{header}"' in text, header
    code = re.sub(r"//[^\n]*", "", text)  # the code, without its comments
    narrow, wide = code.split("namespace wide {", 1)
    # bf16: the panel and epilogue of K3's loop, wgmma from shared memory (fc1) and from
    # registers (fc2), weights by the TMA; fp32: K3's FMA stage
    for call in ("panel_start<", "epilogue_bf16<", "wgmma_m64n64k16(", "wgmma_m64n256k16_rs(",
                 "tma_load_2d(", "fma_stage_fp32<"):
        assert call in narrow, call
    for banned in ("<mma.h>", "wmma::", "wmma", "tf32"):
        assert banned not in narrow, banned
    for call in ("pw::panel<", "pw::wide_epilogue_bf16<", "wgmma_m64n32k16(",
                 "wgmma_m64n256k16_ss<0, 0>(", "tma_load_2d(", "mbar_expect_tx(",
                 "setmaxnreg_inc<", "pw::mma_3xtf32(", "b_frag_parts<", "gelu_fma(",
                 "pcdiff_ln::DivFast{ok}", "pcdiff_ln::DivRn()", "combine_partials("):
        assert call in wide, call
    for banned in ("wmma", "mma_tf32(", "atomic", "fma_stage_fp32", "b_frag_tf32("):
        assert banned not in wide, banned
    ptx = (_native.CSRC_DIR / "ptx.cuh").read_text()
    for op in ("wgmma.mma_async.sync.aligned.m64n256k16", "wgmma.mma_async.sync.aligned.m64n32k16",
               "cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity", "setmaxnreg"):
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


# The flagship's loops, byte for byte: the shared bf16 attention loop (K1 at head dim 32, K7
# bf16, K8) and the narrow K3 block with its epilogues (also K5's and K4's); the Point-E
# path's kernels were redesigned beside them, in their own code
FLAGSHIP_LOOPS = {
    "attention_fwd.cuh": "bb679055e448b8601c4ecea52144abfd0b89c262cf74832fe58fc7d8d31193c4",
    "ln_dense_fwd.cuh": "df36eedc1d540585412ec035891263d4054507b65d61b672f6b14376cd686a3a",
}


@pytest.mark.parametrize("name", list(FLAGSHIP_LOOPS))
def test_flagship_loops_are_unchanged(name):
    import hashlib

    digest = hashlib.sha256((_native.CSRC_DIR / name).read_bytes()).hexdigest()
    assert digest == FLAGSHIP_LOOPS[name], f"{name} changed"


def _code(name):
    return re.sub(r"//[^\n]*", "", (_native.CSRC_DIR / name).read_text())


def test_k1_head_dim_64_builds_on_wgmma_tma_and_mbarriers():
    """K1 at head dim 64 (``attention_mh64.cu``): a producer warpgroup's TMA loads into an
    mbarrier ring, S = Q K^T and P V on ``wgmma`` (P from registers, V MN-major), registers
    moved to the consumers by ``setmaxnreg``; no ``mma.sync``, ``cp.async`` or atomics. It
    holds the bf16 exp mode too, as a template parameter (a first sweep for the row max, the
    maxes traded over the cluster, the two roundings against it), and the shared loop
    (``attention_mh.cu``) builds no head-dim-64 mode."""
    code = _code("attention_mh64.cu")
    for call in ("tma_load_3d(", "mbar_wait(", "mbar_arrive(", "mbar_expect_tx(",
                 "wgmma_m64n128k16(", "wgmma_m64n64k16_rs<1>(", "sw128_desc_mn(",
                 "setmaxnreg_inc<", "setmaxnreg_dec<", "ex2(", "pcdiff_tma::tensor_map("):
        assert call in code, call
    for banned in ("mma_bf16(", "cp_async_16(", "atomic", "attention_fwd.cuh"):
        assert banned not in code, banned
    assert "template <typename TO, bool EXP>" in code
    for call in ("launch<float, true>(", "launch<bf16, true>(", "trade_max(", "cluster_arrive(",
                 "pack_bf16(ex2(bf16_lo(t) * LOG2E), ex2(bf16_hi(t) * LOG2E))"):
        assert call in code, call
    mh = _code("attention_mh.cu")
    assert "launch<FULL, " in mh and "launch<EXP, " in mh
    for gone in ("launch_loop", "HD_", "head_dim == 64"):
        assert gone not in mh, gone


def test_k3_wide_rows_build_on_wgmma_tma_and_3xtf32():
    """K3's wide rows (``ln_dense.cu`` namespace ``wide``): the bf16 path streams W by the TMA
    through an mbarrier ring into ``wgmma`` with a producer warpgroup (``setmaxnreg``), the
    fp32 path multiplies in 3xTF32 on ``mma.sync``; both normalise each row once (no
    per-column-tile pass) and take the epilogue's divisions on DivFast with a DivRn retake.
    The panel's normalisation, the bf16 epilogue and the TF32 split are ``ln_wide.cuh``'s,
    which the whole-MLP kernel's wide rows share."""
    text = (_native.CSRC_DIR / "ln_dense.cu").read_text()
    assert '#include "ln_wide.cuh"' in text
    wide = re.sub(r"//[^\n]*", "", text[text.index("namespace wide {"):]) + _code("ln_wide.cuh")
    for call in ("tma_load_2d(", "mbar_wait(", "mbar_arrive(", "mbar_expect_tx(",
                 "wgmma_m64k16<N>(", "setmaxnreg_inc<", "setmaxnreg_dec<", "mma_tf32(",
                 "round_tf32(", "pcdiff_ln::DivFast{ok}", "pcdiff_ln::DivRn()",
                 "pcdiff_tma::tensor_map("):
        assert call in wide, call
    for banned in ("fma_stage_fp32", "wide_a_stage", "wmma", "atomic"):
        assert banned not in wide, banned
    assert wide.count("mma_tf32(") == 3  # lo hi, hi lo, hi hi


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wide_panels_and_rings_fit_an_sm():
    """The wide K3's resident panels and rings, K5's wide rows' panel, h slots and ring (which
    also hold a cluster partner's 64 x 512 fp32 partial tile), and K1's ring at head dim 64,
    fit the 227 KB of shared memory a block may take, at every width of the wide path: panels
    of the most of
    128, 64 or 32 rows whose k blocks (128 bytes a row) take at most PANEL_BYTES (bf16: 128
    rows to C = 512, 64 past it; fp32: 64 and 32) beside STAGES W boxes of BN rows."""
    text = (_native.CSRC_DIR / "ln_dense.cu").read_text()
    stages, bn = (_constant(text, n) for n in ("STAGES", "BN"))
    box = _constant((_native.CSRC_DIR / "ln_wide.cuh").read_text(), "BOX_BYTES")
    panel = 128 * 1024
    assert "constexpr int PANEL_BYTES = 128 * 1024;" in text
    limit = 232448
    for c in range(288, 1025, 32):
        for size in (2, 4):
            bk = box // size
            kext = -(-c // bk) * bk
            rows = next(r for r in (128, 64, 32) if r * kext * size <= panel)
            assert (size, rows) in {(2, 128 if kext <= 512 else 64),
                                    (4, 64 if c <= 512 else 32)}, (c, size, rows)
            assert 1024 + rows * kext * size + stages * bn * box + 8 * (2 * stages + 1) <= limit
    # K5's wide rows: a 64-row panel 512 deep, two h slots of 64 x 64, and a ring of 32 KB
    # stages (bf16: four; fp32: two), with their barriers
    mlp = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    pr, kp, fc, slot = (_constant(mlp, n) for n in ("PR", "KP", "WFC", "SLOT_BYTES"))
    for size, stages in ((2, _constant(mlp, "B_STAGES")), (4, _constant(mlp, "F_STAGES"))):
        assert 1024 + (pr * kp + 2 * pr * fc) * size + stages * slot + 8 * (2 * stages + 1) <= limit
        assert pr * 128 * 4 <= pr * kp * size + 2 * pr * fc * size + stages * slot  # rank 1's partial
    k1 = (_native.CSRC_DIR / "attention_mh64.cu").read_text()
    bq, bkv, k1_stages = (_constant(k1, n) for n in ("BQ", "BKV", "STAGES"))
    part = 16 * (64 // 8 + 2) * 256  # the merge's partials and the exp mode's maxes: 10
                                     # float4 a consumer thread
    assert 1024 + 2 * 64 * (bq + 2 * k1_stages * bkv) + part + 8 * (2 * k1_stages + 1) <= limit


def test_k5_past_the_wide_rows_builds_on_a_cluster_pair():
    """K5 past C = 512 (``ln_mlp.cu`` namespace ``pair``, base300M's MLP): a cluster of four
    blocks, two 64-row tiles by the two halves of O; x multicast to a row tile's two blocks and
    every weight stage to an O half's two (one box from each, each block's full barrier armed
    for the whole stage), a slot refilled once both twins' consumer warps have arrived on its
    empty barrier (their own block's and, remotely, the twin's: 16 arrivals); each block's half
    of every h chunk copied into its peer's shared memory by the bulk-copy unit; bf16 ``wgmma``
    on the wide rows' panel, GELU store and epilogue; no atomics; the launcher's cluster of four
    and 64-row W boxes; the panel, two h slots and the ring within 227 KB; its widest C the
    wrapper's."""
    from pcdiff_torch.ops import ln_mlp as lm

    text = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    pair = text[text.index("namespace pair {"):text.index("}  // namespace pair")]
    code = re.sub(r"//[^\n]*", "", pair)
    for call in ("bulk_copy_to_peer(", "mbar_wait_cluster(", "cluster_sync(",
                 "wgmma_m64n32k16(", "wgmma_m64n128k16(", "wide::store_hidden<ACT>(",
                 "pw::wide_epilogue_bf16<", "pw::panel<", "setmaxnreg_inc<",
                 "mbar_arrive_remote(&empty[s % STAGES], twin)", "mbar_arrive_peer(&pempty",
                 "mbar_init(&ring.empty[i], 2 * CONSUMERS / 32)",
                 "mbar_expect_tx(&full[s % STAGES], STAGE_BYTES)", "rank ^ 2u",
                 "(unsigned short)(5u << half)", "(unsigned short)(3u << (2 * tile))"):
        assert call in code, call
    assert code.count("tma_load_2d_multicast(") == 2  # x and the weights
    assert "tma_load_2d(" not in code and "wide::Ring<" not in code
    for banned in ("atomic", "mma_tf32(", "fma_stage_fp32", "wmma"):
        assert banned not in code, banned
    ptx = (_native.CSRC_DIR / "ptx.cuh").read_text()
    for op in (".multicast::cluster", "cp.async.bulk.shared::cluster.shared::cta",
               "mbarrier.arrive.release.cluster.shared::cluster",
               "mbarrier.arrive.shared::cluster.b64",
               "mbarrier.try_wait.parity.acquire.cluster", "mapa.shared::cluster"):
        assert op in ptx, op
    host = text[text.index("int launch_pair(wide::WideArgs& a"):]
    host = host[:host.index("\n}\n")]
    for line in ("a.splits = pair::CLUSTER;",
                 "blocks = (unsigned)pair::CLUSTER * ((tiles + 1) / 2);",
                 "map_2d<bf16>(&a.w1_map, w1, c, f, 64)", "map_2d<bf16>(&a.w2_map, w2, f, o, 64)"):
        assert line in host, line
    pr, kp, hc, stages, stage, cluster = (
        _constant(pair, n) for n in ("PR", "KP", "HC", "STAGES", "STAGE_BYTES", "CLUSTER"))
    # a stage: one 64 x 64 box of bf16 from each twin
    assert "constexpr int BOX_ELEMS = 64 * 64;" in pair and 2 * 64 * 64 * 2 == stage
    assert 1024 + (pr * kp + 2 * pr * hc) * 2 + stages * stage + 8 * (2 * stages + 5) <= 232448
    assert _constant(pair, "MAX_C") == kp == lm._MAX_C_PAIR
    assert (pr, cluster) == (lm._PAIR_ROWS, lm._PAIR_CLUSTER)


# clusters of 1-4 blocks an H100 80GB HBM3 ran at once, one block an SM on 132 SMs (the
# card's own count comes from pcdiff_attention_mh64_tiling)
H100_CLUSTERS = (132, 66, 39, 30)


@pytest.mark.parametrize("panel,want", [
    ((16, 257, 257), 1),     # ViT-L/14: 48 query tiles of 3 key tiles, one short wave
    ((16, 1281, 1281), 1),   # base40M at 2B rows: 176 of 11, two waves either way
    ((16, 1026, 1026), 1),   # base40M-textvec at 2B rows: 144 of 9
    ((8, 4353, 4353), 2),    # the upsampler: 280 of 35, a last wave of 16 unsplit
    ((4, 4096, 4096), 1),    # the SDF model: 128 of 32, one wave unsplit
    ((4, 3, 1281), 4),       # one short query tile a panel: its keys over 4 blocks
])
def test_k1_64_split_plan_matches_the_kernel(panel, want):
    """``fa._k1_64_splits`` plans with the head-dim-64 kernel's query and key tiles and its
    largest cluster, gives every block of a cluster at least one key tile, and at the Point-E
    path's panels on an H100's capacity splits only where the query tiles fill their last wave
    poorly enough to pay for a split block's merge."""
    from pcdiff_torch.ops import flash_attention as fa

    text = (_native.CSRC_DIR / "attention_mh64.cu").read_text()
    for name, value in (("BQ", fa._K1_64_BQ), ("BKV", fa._K1_64_BKV),
                        ("MAX_SPLITS", fa._K1_64_MAX_SPLITS)):
        assert _constant(text, name) == value, name
    panels, nq, nk = panel
    splits = fa._k1_64_splits(panels, nq, nk, H100_CLUSTERS)
    assert 1 <= splits <= min(fa._K1_64_MAX_SPLITS, -(-nk // fa._K1_64_BKV))
    assert splits == want


@pytest.mark.parametrize("rows,clusters", [
    (1, 1),          # one short tile, its cluster's second tile past the rows
    (65, 1),         # a full tile and a 1-row tile
    (131, 2),        # the ragged off-path shape: a lone 3-row tile in the last cluster
    (2562, 21),      # base300M's 2B rows at B = 1: 41 tiles, the last of 2 rows alone
    (4 * 2562, 81),  # at B = 4: 161 tiles
])
def test_k5_pair_clusters_match_the_launcher(rows, clusters):
    """``lm._pair_clusters`` gives the clusters of four that ``launch_pair`` launches; on an
    H100's 30 co-resident clusters of four, B = 1 takes one wave and B = 4 three."""
    from pcdiff_torch.ops import ln_mlp as lm

    got = lm._pair_clusters(rows)
    assert got == clusters and 2 * got * lm._PAIR_ROWS >= rows > 2 * (got - 1) * lm._PAIR_ROWS
    assert -(-got // H100_CLUSTERS[lm._PAIR_CLUSTER - 1]) == (1 if rows <= 2562 else 3)


@pytest.mark.parametrize("cut", list(k3_wide_cuts.CUTS), ids=" / ".join)
def test_k3_wide_cuts_apply_to_the_kernel_source(cut):
    text = k3_wide_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "ln_dense.cu").read_text()
