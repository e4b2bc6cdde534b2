"""Time K7's fp32 path on the card with parts of its work cut, or done another way, at compile
time.

    python -m pcdiff_torch.scripts.k7_cuts [--iters N] [--out outputs/k7_cuts.txt]

Each entry of :data:`CUTS` is a copy of ``csrc/attention.cu`` with textual substitutions in
``head_split_attention_fp32_kernel``'s code, built by ``nvcc`` as the kernel itself is
(``ops/_native.py``'s flags, into ``build/pcdiff_torch/k7_cuts``) and timed with CUDA events
through ``ops.flash_attention._launch_split`` (its entry point swapped for the cut's) at the
train step's three backbone sites (``chip_smoke.K7_SITES``, fp32, B rows), each time a
call and per train step (the sites' launches a step). A cut removes a piece of the work (its
output is wrong by design: only its time is read), so the kernel's time less the cut's is
what the piece costs where it does not overlap the rest; a variant (marked so) computes the
same function another way. The substitutions must match the source exactly, so the script
(and a CPU test) fails when the kernel changes under them. The table, each entry's ptxas
registers and spills, is printed and written to ``--out`` with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from ..ops import _native
from ..ops import flash_attention as fa

# the fp32 path's pieces, as they stand in csrc/attention.cu
_ROUND = ("  hi = pcdiff_ptx::round_tf32(x);\n"
          "  lo = pcdiff_ptx::round_tf32(x - __uint_as_float(hi));\n")
_K_SPLIT = ("        split_tf32(__uint_as_float(raw[2 * h]), b_hi[0], b_lo[0]);\n"
            "        split_tf32(__uint_as_float(raw[2 * h + 1]), b_hi[1], b_lo[1]);\n")
_V_SPLIT = ("      split_tf32(kv[i0], b_hi[0], b_lo[0]);\n"
            "      split_tf32(kv[i0 + LD], b_hi[1], b_lo[1]);\n")
_P_SPLIT = ("    split_tf32(s[j][0], a_hi[0], a_lo[0]);\n"
            "    split_tf32(s[j][2], a_hi[1], a_lo[1]);\n"
            "    split_tf32(s[j][1], a_hi[2], a_lo[2]);\n"
            "    split_tf32(s[j][3], a_hi[3], a_lo[3]);\n")
_SMALL = ("  pcdiff_ptx::mma_tf32(d, a_lo, b_hi[0], b_hi[1]);\n"
          "  pcdiff_ptx::mma_tf32(d, a_hi, b_lo[0], b_lo[1]);\n")
_EXP = "      s[j][e] = pcdiff_ptx::ex2(fmaf(s[j][e], pcdiff_attn::LOG2E, -off[e >> 1]));\n"
_BOUNDS = "__global__ void __launch_bounds__(THREADS, D == 32 ? 3 : 2)\n"
_SMEM = "  static constexpr int SMEM = (STAGES + 1) * 2 * TILE * 4;  // bytes\n"
_TILE_FN = "// One key tile through one warp's 16 query rows"
_TILE_TOP = ("  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;\n\n"
             "  float s[NT][4];\n")
_K_LOAD = "      pcdiff_ptx::ldmatrix_x4(raw, k_lane + 16 * jp * LD + 8 * kc);\n"
_CALL = "    if (active) tile_fp32<D>(o, m, l, q_warp, ring + stage * 2 * C::TILE, k0, nk);\n"
# the block's split of a staged tile into shared memory: hi in place, lo in one more K/V tile
# past the ring's stages and Q's parts, 16 bytes a thread at a time
_SPLIT_TILE = """template <int D>
__device__ __forceinline__ void split_tile(float* kv, float* lo) {
  constexpr int LD = Cfg<D>::LD, CH = D / 4;
  for (int c = threadIdx.x; c < 2 * BK * CH; c += THREADS) {
    const int off = (c / CH) * LD + (c % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(kv + off);
    uint4 hi, lw;
    split_tf32(x.x, hi.x, lw.x);
    split_tf32(x.y, hi.y, lw.y);
    split_tf32(x.z, hi.z, lw.z);
    split_tf32(x.w, hi.w, lw.w);
    *reinterpret_cast<uint4*>(kv + off) = hi;
    *reinterpret_cast<uint4*>(lo + off) = lw;
  }
}

"""

# name -> substitutions (old, new); a "variant" computes the same function another way
CUTS = {
    "no K/V split": [
        (_K_SPLIT, "        b_hi[0] = raw[2 * h], b_lo[0] = 0u;\n"
                   "        b_hi[1] = raw[2 * h + 1], b_lo[1] = 0u;\n"),
        (_V_SPLIT, "      b_hi[0] = __float_as_uint(kv[i0]), b_lo[0] = 0u;\n"
                   "      b_hi[1] = __float_as_uint(kv[i0 + LD]), b_lo[1] = 0u;\n")],
    "no P split": [
        (_P_SPLIT, "".join(f"    a_hi[{i}] = __float_as_uint(s[j][{e}]), a_lo[{i}] = 0u;\n"
                           for i, e in enumerate((0, 2, 1, 3))))],
    "1xTF32 (no small products)": [(_SMALL, "")],
    "no exp": [(_EXP, "      s[j][e] = fmaf(s[j][e], pcdiff_attn::LOG2E, -off[e >> 1]);\n")],
    "variant: K/V split once a tile in shared memory": [
        (_SMEM, "  static constexpr int SMEM = (STAGES + 2) * 2 * TILE * 4;\n"),
        (_TILE_FN, _SPLIT_TILE + _TILE_FN),
        (_TILE_TOP, _TILE_TOP + "  extern __shared__ __align__(16) unsigned char smem[];\n"
                               "  const float* lo = reinterpret_cast<const float*>(smem)"
                               " + (STAGES + 1) * 2 * Cfg<D>::TILE;\n"),
        (_K_SPLIT, "        b_hi[0] = raw[2 * h], b_lo[0] = lw[2 * h];\n"
                   "        b_hi[1] = raw[2 * h + 1], b_lo[1] = lw[2 * h + 1];\n"),
        (_K_LOAD, _K_LOAD + "      unsigned lw[4];\n"
                  "      pcdiff_ptx::ldmatrix_x4(lw, lo + (k_lane - kv) + 16 * jp * LD\n"
                  "                                  + 8 * kc);\n"),
        (_V_SPLIT, "      b_hi[0] = __float_as_uint(kv[i0]), b_lo[0] = __float_as_uint(lo[i0]);\n"
                   "      b_hi[1] = __float_as_uint(kv[i0 + LD]);\n"
                   "      b_lo[1] = __float_as_uint(lo[i0 + LD]);\n"),
        (_CALL, "    split_tile<D>(ring + stage * 2 * C::TILE,\n"
                "                  ring + (STAGES + 1) * 2 * C::TILE);\n"
                "    __syncthreads();  // the tile is split\n" + _CALL)],
    "variant: cvt.rna.tf32.f32": [
        (_ROUND, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));\n')],
    "variant: 4 blocks an SM": [
        (_BOUNDS, "__global__ void __launch_bounds__(THREADS, D == 32 ? 4 : 2)\n")],
}
CUT_DIR = _native.BUILD_DIR / "k7_cuts"


def cut_source(name: str) -> str:
    """``csrc/attention.cu`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "attention.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in attention.cu once")
        text = text.replace(old, new)
    return text


def _build_cuts(argtypes) -> dict:
    """Every cut built at once, one nvcc each; {name: (its entry point, its nvcc log)}."""
    procs = {}
    for i, name in enumerate(CUTS):
        d = CUT_DIR / f"cut{i}"
        d.mkdir(parents=True, exist_ok=True)
        src = d / "attention.cu"
        src.write_text(cut_source(name))
        lib = d / "libattention.so"
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on cut {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).pcdiff_attention_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = (fn, log)
    return out


def _fp32_kernels(log: str) -> str:
    """The fp32 kernels' ptxas registers and spills in ``log``."""
    import chip_smoke as cs

    return "; ".join(f"{r['kernel']} {r.get('registers')} regs, spill "
                     f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} B"
                     for r in cs.ptxas_report(log) if "fp32" in r["kernel"])


def run(iters: int = 20) -> tuple:
    """(rows, ptxas): rows (label, launches a step, {"kernel": ms, cut name: ms}), each time a
    call in the order kernel, cuts, cuts again in reverse, kernel again, each entry the mean
    of its two readings; ptxas {entry: its fp32 kernels' registers and spills}."""
    import chip_smoke as cs

    kernel = fa._k7_kernel_fn()
    built = _build_cuts(kernel.argtypes)
    entries = {"kernel": kernel, **{name: fn for name, (fn, _) in built.items()}}
    ptxas = {"kernel": _fp32_kernels(_native.build_log.get("attention", ""))}
    ptxas.update({name: _fp32_kernels(log) for name, (_, log) in built.items()})
    order = list(entries) + list(entries)[::-1]
    rows = []
    try:
        for label, nq, nk, _, per_step, _ in cs.K7_SITES:
            q, k, v = cs._split_inputs(cs.TRAIN_B, nq, nk, torch.float32)
            times: dict = {}
            for name in order:
                fa._k7_fn = entries[name]
                times.setdefault(name, []).append(
                    cs._time_ms(lambda: fa._launch_split(q, k, v), iters))
            rows.append((f"{label} [{cs.TRAIN_B}x8x{nq}x{nk}x32]", per_step,
                         {k_: sum(t) / len(t) for k_, t in times.items()}))
    finally:
        fa._k7_fn = kernel
    return rows, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="outputs/k7_cuts.txt")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_cuts needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    rows, ptxas = run(opts.iters)
    lines = []
    for label, per_step, t in rows:
        k = t["kernel"]
        cuts = ", ".join(f"{name} {ms:.4f} ({ms - k:+.4f})" for name, ms in t.items()
                         if name != "kernel")
        lines.append(f"{label} x{per_step}: K7 fp32 {k:.4f} ms a call; {cuts}")
    step = {name: sum(per_step * t[name] for _, per_step, t in rows) for name in rows[0][2]}
    lines.append("per train step: " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in step.items()))
    lines += [f"ptxas {name}: {report}" for name, report in ptxas.items()]
    lines.append(f"card: {cs.device_line()}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
