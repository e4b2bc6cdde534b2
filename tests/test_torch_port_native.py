"""The CUDA sources of the port and their build rule, on the CPU (no nvcc).

- ``_native.stale``: a library is rebuilt when its source or a header is newer, and only
  then, so an edit to ``csrc/attention_fwd.cuh`` rebuilds the three libraries that include it.
- The attention sources: K1 (``attention_mh.cu``), K7 (``attention.cu``) and the ladder K8
  (``attention_ladder.cu``) include the one bf16 loop of ``attention_fwd.cuh``; neither K1 nor
  the ladder has a key loop of its own, and K7's own loops belong to its fp32 kernel alone.
  The backward K2 (``attention_mh_bwd.cu``) is built on the same primitives of ``ptx.cuh``
  (``mma.sync``, ``ldmatrix``, ``cp.async``, ``ex2.approx``), with no WMMA and no atomics.
- The whole-MLP kernel K5 (``ln_mlp.cu``) is built on K3's loop (``ln_dense_fwd.cuh``) and
  ``ptx.cuh``: ``wgmma`` for its bf16 products, K3's FMA stage for its fp32 ones, no WMMA;
  the cuts of its profiling script (``scripts/mlp_cuts.py``) still apply to its source.
"""

import os
import re

import pytest

from pcdiff_torch.ops import _native
from pcdiff_torch.scripts import mlp_cuts

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
    # K7 keeps its fp32 FMA loop (two sweeps), and only that: every key loop lies in the
    # body of the fp32 kernel, which uses no bf16 and no tensor-core instruction
    start = text.index("head_split_attention_fp32_kernel(const Args a)")
    end = text.index("\n}\n", start)
    assert len(loops) == 2 and all(start < i < end for i in loops)
    assert not re.search(r"bf16|mma|ldmatrix", text[start:end])


def test_header_holds_the_bf16_key_loop():
    text = (_native.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert re.search(r"for \(int t = 0; t < ntiles; \+\+t\)", text)
    # the PTX primitives the loop is built from live in ptx.cuh, which the header includes
    assert '#include "ptx.cuh"' in text
    text += (_native.CSRC_DIR / "ptx.cuh").read_text()
    for op in ("mma.sync.aligned.m16n8k16", "ldmatrix", "cp.async.cg", "ex2.approx"):
        assert op in text, op


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
    assert len(kernels) == 7 and all("ln_denses_bwd" in k and "ln_denses_kernel" not in k
                                     for k in kernels), kernels
    check = (_native.CSRC_DIR / "act_check.cu").read_text()
    assert "act_grad<ACT>(v, pcdiff_ln::DivFast{ok})" in check


@pytest.mark.parametrize("cut", list(mlp_cuts.CUTS), ids=" / ".join)
def test_mlp_cuts_apply_to_the_kernel_source(cut):
    text = mlp_cuts.cut_source(cut)  # raises if a substitution no longer matches once
    assert text != (_native.CSRC_DIR / "ln_mlp.cu").read_text()
