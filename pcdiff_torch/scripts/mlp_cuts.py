"""Time the whole-MLP kernel K5 on the card with parts of its work cut at compile time.

    python -m pcdiff_torch.scripts.mlp_cuts [--iters N]

Each cut is a copy of ``csrc/ln_mlp.cu`` with one piece of the kernel's work removed by a
textual substitution (:data:`CUTS`), built by ``nvcc`` as the kernel itself is
(``ops/_native.py``'s flags, into ``build/pcdiff_torch/cuts``) and timed with CUDA events at
the flagship's two K5 sites: the z site (643 tokens a row) and the x site (1024), at the
sampler's 2B = 64 rows in bf16 with the tanh GELU and at the train step's B = 32 rows in
fp32 with the exact GELU, each also with no activation (the kernel's own ACT_NONE
instantiation, not a cut); and the wide rows (``namespace wide``) at Point-E's two sites of
the image pipeline at B = 1 (base40M's 2B = 2 rows of 1281 tokens, the upsampler's 4353), C = O
= 512, F = 2048, exact GELU, both dtypes. The kernel's time less a cut's is what the cut piece costs where
it does not overlap the rest of the work. A cut's output is wrong by design: only its time
is read. The substitutions must match the source exactly, so the script (and a CPU test)
fails when the kernel changes under them. The table is printed and written to
``outputs/mlp_cuts.txt``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import time

import torch

from ..ops import _native
from ..ops import ln_dense as ld
from ..ops import ln_mlp as lm

# the kernel's pieces, as they stand in csrc/ln_mlp.cu
_FC1 = ("      wgmma_m64n64k16(acc1, sw128_desc(a_wg + kb * (BM * 64) + 16 * ks),\n"
        "                      sw128_desc(w1s + kb * 64 * 64 + 16 * ks), kb > 0 || ks > 0);")
_FC2 = "    wgmma_m64n256k16_rs(acc2, hf[kk], sw128_desc(w2s + 16 * kk), 1);"
_REFILL = "    if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);"
_AWAIT = "  auto await = [&](int s) { mbar_wait(&full[s % STAGES], (s / STAGES) & 1); };"
_FMA1A = "      pcdiff_ln::fma_stage_fp32<1>(acc1, sa + ty * lda + 64 * r, lda, ws);"
_FMA1B = ("        pcdiff_ln::fma_stage_fp32<1>(acc1, sa + ty * lda + 64 * r + 32, lda,"
          " ws + 64 * 32);")
_FMA2 = ("        pcdiff_ln::fma_stage_fp32<2>(acc2[nh], sh + ty * H_LD + 32 * kk, H_LD,"
         " step(s++));")

# the wide rows' pieces
_W_FC1 = ("      wgmma_m64n32k16(acc1, da + (kb * PR * 64 * 2 + 32 * ks) / 16,\n"
          "                      db + (kb * 64 * 64 * 2 + 32 * ks) / 16, !first || kb > 0 || ks > 0);")
_W_FC2 = "    wgmma_m64n256k16_ss<0, 0>(acc2, da + 2 * kk, db + 2 * kk, 1);"
_W_GELU = ("    hidden_pairs<ACT>(acc, p, b1, hp, pcdiff_ln::DivFast{ok});\n"
           "    if (ACT != ACT_GELU && !ok) hidden_pairs<ACT>(acc, p, b1, hp, "
           "pcdiff_ln::DivRn());")
_W_FILL = "    mbar_expect_tx(&full[s % STAGES], BYTES);\n    return &full[s % STAGES];"
_W_W1 = ("        tma_load_2d(dst + kb * 64 * 64, &a.w1_map, bar, 256 * j + 64 * kb, "
         "(sh.c0 + t) * WFC);")
_W_W2 = "      tma_load_2d(ring.slot(s), &a.w2_map, ring.fill(s), (sh.c0 + t) * WFC, 256 * h);"
_W_FP32_W1 = ("          tma_load_2d(dst + (2 * p + kb) * 64 * 32, p ? &a.w1lo_map : &a.w1_map, "
              "bar,\n                      64 * j + 32 * kb, f0);")
_W_FP32_W2 = ("        tma_load_2d(dst + p * W2_ROWS * 32, p ? &a.w2lo_map : &a.w2_map, bar, "
              "f0 + 32 * (q / 4),\n                    W2_ROWS * (q % 4));")
_W_FP32_FC1 = "        pw::mma_3xtf32(acc1[nt], ahi, alo, bhi, blo);"
_W_FP32_FC2 = "      pw::mma_3xtf32(acc2[8 * Q + nt], ahi, alo, bhi, blo);"
_W_FP32_ACT = ("  act_frags<ACT>(acc, b, v, pcdiff_ln::DivFast{ok});\n"
               "  if (ACT != ACT_GELU && !ok) act_frags<ACT>(acc, b, v, pcdiff_ln::DivRn());")
# every stage completes without a copy: the consumers multiply stale slots
_W_NO_STREAM = [(_W_FILL, "    mbar_arrive(&full[s % STAGES]);\n    return &full[s % STAGES];")]

# (path, cut name) -> substitutions (old, new)
CUTS = {
    ("bf16", "no fc1"): [(_FC1, "      ;")],
    ("bf16", "no fc2"): [(_FC2, "    ;")],
    ("bf16", "no products"): [(_FC1, "      ;"), (_FC2, "    ;")],
    # the producer fills the ring once; the consumers then reuse its stale slots
    ("bf16", "no weight stream"): [
        (_REFILL, "    if (use > 0) break;"),
        (_AWAIT, "  auto await = [&](int s) { if (s < STAGES) mbar_wait(&full[s % STAGES], "
                 "(s / STAGES) & 1); };")],
    ("fp32", "no fc1"): [(_FMA1A, "      (void)ws;"), (_FMA1B, "        ;")],
    ("fp32", "no fc2"): [(_FMA2, "        step(s++);")],
    ("fp32", "no FMA"): [(_FMA1A, "      (void)ws;"), (_FMA1B, "        ;"),
                         (_FMA2, "        step(s++);")],
    ("wide bf16", "no weight stream"): _W_NO_STREAM + [
        (_W_W1, "        (void)bar, (void)dst;"), (_W_W2, "      ring.fill(s);")],
    ("wide bf16", "no GELU"): [
        (_W_GELU, "    hidden_pairs<ACT_NONE>(acc, p, b1, hp, pcdiff_ln::DivRn());")],
    ("wide bf16", "no fc1"): [(_W_FC1, "      ;")],
    ("wide bf16", "no fc2"): [(_W_FC2, "    ;")],
    ("wide fp32", "no weight stream"): _W_NO_STREAM + [
        (_W_FP32_W1, "          (void)bar, (void)dst;"),
        (_W_FP32_W2, "        (void)bar, (void)dst;")],
    ("wide fp32", "no GELU"): [(_W_FP32_ACT, "  act_frags<ACT_NONE>(acc, b, v, pcdiff_ln::DivRn());")],
    ("wide fp32", "no fc1"): [(_W_FP32_FC1, "        (void)bhi, (void)blo;")],
    ("wide fp32", "no fc2"): [(_W_FP32_FC2, "      (void)bhi, (void)blo;")],
}
# (label, rows, tokens) per path, and the path's dtype, activation and (C, F, O)
SITES = {"bf16": [("z", 64, 643), ("x", 64, 1024)], "fp32": [("z", 32, 643), ("x", 32, 1024)],
         "wide bf16": [("base40M 2B", 2, 1281), ("upsample", 1, 4353)],
         "wide fp32": [("base40M 2B", 2, 1281), ("upsample", 1, 4353)]}
PATHS = {"bf16": (torch.bfloat16, "gelu_tanh"), "fp32": (torch.float32, "gelu"),
         "wide bf16": (torch.bfloat16, "gelu"), "wide fp32": (torch.float32, "gelu")}
SHAPES = {"bf16": (256, 1024, 256), "fp32": (256, 1024, 256), "wide bf16": (512, 2048, 512),
          "wide fp32": (512, 2048, 512)}
CUT_DIR = _native.BUILD_DIR / "cuts"


def cut_source(name: tuple) -> str:
    """``csrc/ln_mlp.cu`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in ln_mlp.cu once")
        text = text.replace(old, new)
    return text


def _build_cuts() -> dict:
    """Every cut built at once, one nvcc each; {name: the loaded entry point}."""
    CUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(CUTS):
        src = CUT_DIR / f"ln_mlp_cut{i}.cu"
        src.write_text(cut_source(name))
        lib = CUT_DIR / f"libln_mlp_cut{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on cut {name}:\n{log}")
        fns[name] = _entry(ctypes.CDLL(str(lib)))
    return fns


def _entry(lib):
    fn = lib.pcdiff_ln_mlp_fwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [i32] * 5 + [ctypes.c_float, i32, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def _inputs(g, rows, n, dtype, c, f, o):
    """chip_smoke.py's K5 inputs: x [rows * n, C] and the fp32 parameters."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x = (torch.randn(rows * n, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    return (x, 1 + 0.2 * torch.randn(c, generator=g, device=dev),
            0.2 * torch.randn(c, generator=g, device=dev),
            torch.randn(f, c, generator=g, device=dev) / c ** 0.5,
            0.2 * torch.randn(f, generator=g, device=dev),
            torch.randn(o, f, generator=g, device=dev) / f ** 0.5,
            0.2 * torch.randn(o, generator=g, device=dev))


def _time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls, queued behind a spin
    kernel so that the events time the card and not the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * host + 1e-3) * 2.5e9))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(iters: int = 20) -> list:
    """Rows (path, site, act, {"kernel": ms, cut name: ms})."""
    kernel = _entry(_native.library("ln_mlp"))
    cuts = _build_cuts()
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = _native.stream(torch.device("cuda", torch.cuda.current_device()))
    rows = []
    for path, sites in SITES.items():
        dtype, act = PATHS[path]
        c, f, o = SHAPES[path]
        for label, b, n in sites:
            x, scale, bias, w1, b1, w2, b2 = _inputs(g, b, n, dtype, c, f, o)
            if dtype == torch.bfloat16:
                w1, w2 = ld._product_weight(w1), ld._product_weight(w2)
            elif path == "wide fp32":  # the wide fp32 path takes the weights' TF32 parts
                w1, w2 = lm._split_weight(w1), lm._split_weight(w2)
            out = torch.empty(b * n, o, dtype=dtype, device=x.device)
            for a in (act, None) if c == 256 else (act,):
                def call(fn, code=ld._ACT_CODES[a]):
                    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
                             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                             b * n, c, f, o, code, 1e-5, int(dtype == torch.bfloat16),
                             int(dtype == torch.bfloat16), stream)
                    if err:
                        raise RuntimeError(f"ln_mlp launch failed: cudaError_t {err}")
                times = {"kernel": _time_ms(lambda: call(kernel), iters)}
                for (p, cut), fn in cuts.items():
                    if p == path:
                        times[cut] = _time_ms(lambda fn=fn: call(fn), iters)
                rows.append((path, label, a, times))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlp_cuts needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [f"K5 with parts cut, ms a launch (mean of {args.iters}) [{card.splitlines()[0]}]"]
    for path, label, act, times in run(args.iters):
        cells = ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        lines.append(f"{path} {label} site, act={act}: {cells}")
    print("\n".join(lines))
    os.makedirs("outputs", exist_ok=True)
    with open("outputs/mlp_cuts.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
