"""Time the whole-MLP kernel K5 on the card with parts of its work cut at compile time.

    python -m pcdiff_torch.scripts.mlp_cuts [--iters N] [--paths PATH ...] [--parent CSRC]

Each cut is a copy of ``csrc/ln_mlp.cu`` with one piece of the kernel's work removed by a
textual substitution (:data:`CUTS`), built by ``nvcc`` as the kernel itself is
(``ops/_native.py``'s flags, into ``build/pcdiff_torch/cuts``) and timed with CUDA events at
the flagship's two K5 sites: the z site (643 tokens a row) and the x site (1024), at the
sampler's 2B = 64 rows in bf16 with the tanh GELU and at the train step's B = 32 rows in
fp32 with the exact GELU, each also with no activation (the kernel's own ACT_NONE
instantiation, not a cut); and the wide rows (``namespace wide``) at Point-E's two sites of
the image pipeline at B = 1 (base40M's 2B = 2 rows of 1281 tokens, the upsampler's 4353), C = O
= 512, F = 2048, exact GELU, both dtypes; and the wide rows past C = 512 (``namespace pair``) at
base300M's two sites of the image pipeline (2B = 2 and 8 rows of 1281 tokens), C = O = 1024, F
= 4096, exact GELU, bf16. ``--paths`` keeps only the named paths. The kernel's time less a
cut's is what the cut piece costs where it does not overlap the rest of the work.
``--parent`` names the ``csrc`` directory of another checkout (a parent commit unpacked by
``git archive``), or several ("parent1", "parent2", ...): each one's ``ln_mlp.cu`` is built
beside the cuts and timed against the kernel in turns, parent, kernel, kernel, parent, at
every site, and the two outputs are compared for bit-equality. A cut's output is wrong by
design: only its time is read. The substitutions must match the source exactly, so the
script (and a CPU test) fails when the kernel changes under them. The table is printed and
written to ``outputs/mlp_cuts.txt``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
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
# the pair's pieces (namespace pair)
_P_FC1 = ("    wgmma_m64n32k16(acc1, dx + ((k / 4) * PR * 128 + 32 * (k % 4)) / 16,\n"
          "                    dw + ((k / 4) * 64 * 128 + 32 * (k % 4)) / 16, !first || k > 0);")
_P_FC2 = "  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(acc, dh + 2 * kk, dw + 2 * kk, 1);"
_P_GELU = ("  wide::store_hidden<ACT>(acc1, b1, mine, wg);",
           "    wide::store_hidden<ACT, 0, 1>(acc1, bias, ht, wg);",
           "    wide::store_hidden<ACT, 1, 2>(acc1, bias, ht, wg);  // while they load")
_P_COPY = ("      mbar_expect_tx(&hfull[t % 2], PR * 64 * (unsigned)sizeof(bf16));  "
           "// the peer's half",
           "      bulk_copy_to_peer(half, half, PR * 64 * sizeof(bf16), &hfull[t % 2], peer);")
_P_FILL = "    mbar_expect_tx(&full[s % STAGES], STAGE_BYTES);"
_P_W = ("    tma_load_2d_multicast(ring.slot(s) + BOX_ELEMS * (int)tile, map, bar, c0, c1, "
        "twins);")
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
    # both twins' producers still wait for their slots' release, so the twins keep in step
    ("pair bf16", "no weight stream"): [(_P_FILL, "    mbar_arrive(&full[s % STAGES]);"),
                                        (_P_W, "    (void)map, (void)bar, (void)c0, (void)c1;")],
    ("pair bf16", "no fc1"): [(_P_FC1, "    ;")],
    ("pair bf16", "no fc2"): [(_P_FC2, "  (void)dh, (void)dw;")],
    # h is left as it stood in the slot: fc2 multiplies stale values
    ("pair bf16", "no GELU store"): [(_P_GELU[0], "  (void)b1;"),
                                     (_P_GELU[1], "    (void)ht, (void)bias;"),
                                     (_P_GELU[2], "    ;")],
    # the block's own arrival completes the peer's half of each slot: fc2 reads stale halves
    ("pair bf16", "no h copy"): [(_P_COPY[0], "      mbar_arrive(&hfull[t % 2]);"),
                                 (_P_COPY[1], "      (void)half;")],
}
# (label, rows, tokens) per path, and the path's dtype, activation and (C, F, O)
SITES = {"bf16": [("z", 64, 643), ("x", 64, 1024)], "fp32": [("z", 32, 643), ("x", 32, 1024)],
         "wide bf16": [("base40M 2B", 2, 1281), ("upsample", 1, 4353)],
         "wide fp32": [("base40M 2B", 2, 1281), ("upsample", 1, 4353)],
         "pair bf16": [("base300M 2B", 2, 1281), ("base300M 2B, B = 4", 8, 1281)]}
PATHS = {"bf16": (torch.bfloat16, "gelu_tanh"), "fp32": (torch.float32, "gelu"),
         "wide bf16": (torch.bfloat16, "gelu"), "wide fp32": (torch.float32, "gelu"),
         "pair bf16": (torch.bfloat16, "gelu")}
SHAPES = {"bf16": (256, 1024, 256), "fp32": (256, 1024, 256), "wide bf16": (512, 2048, 512),
          "wide fp32": (512, 2048, 512), "pair bf16": (1024, 4096, 1024)}
CUT_DIR = _native.BUILD_DIR / "cuts"


def cut_source(name: tuple) -> str:
    """``csrc/ln_mlp.cu`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "ln_mlp.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in ln_mlp.cu once")
        text = text.replace(old, new)
    return text


def _build_cuts(names, parents=None) -> dict:
    """The cuts ``names`` built at once, one nvcc each, and each of ``parents`` (label:
    ``csrc`` directory) that tree's ``ln_mlp.cu`` under its label; {name: the loaded entry
    point}."""
    CUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}

    def nvcc(name, lib, src, include):
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(include), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    for i, name in enumerate(names):
        src = CUT_DIR / f"ln_mlp_cut{i}.cu"
        src.write_text(cut_source(name))
        nvcc(name, CUT_DIR / f"libln_mlp_cut{i}.so", src, _native.CSRC_DIR)
    for label, csrc in (parents or {}).items():
        nvcc(label, CUT_DIR / f"libln_mlp_{label}.so", csrc / "ln_mlp.cu", csrc)
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
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


def run(iters: int = 20, paths=None, parents=()):
    """Yields rows (path, site, act, {"kernel": ms, cut name: ms}) as they are timed; with
    ``parents`` (``csrc`` directories), also each parent's and the kernel's times in turns and
    whether their outputs are bit-equal."""
    paths = list(SITES) if paths is None else paths
    labels = {("parent" if len(parents) == 1 else f"parent{i + 1}"): d
              for i, d in enumerate(parents)}
    kernel = _entry(_native.library("ln_mlp"))
    cuts = _build_cuts([name for name in CUTS if name[0] in paths], labels)
    olds = {label: cuts.pop(label) for label in labels}
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = _native.stream(torch.device("cuda", torch.cuda.current_device()))
    for path in paths:
        dtype, act = PATHS[path]
        c, f, o = SHAPES[path]
        for label, b, n in SITES[path]:
            x, scale, bias, w1, b1, w2, b2 = _inputs(g, b, n, dtype, c, f, o)
            if dtype == torch.bfloat16:
                w1, w2 = ld._product_weight(w1), ld._product_weight(w2)
            elif path == "wide fp32":  # the wide fp32 path takes the weights' TF32 parts
                w1, w2 = lm._split_weight(w1), lm._split_weight(w2)
            out = torch.empty(b * n, o, dtype=dtype, device=x.device)
            for a in (act, None) if c == 256 else (act,):
                def call(fn, code=ld._ACT_CODES[a], out=out):
                    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
                             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                             b * n, c, f, o, code, 1e-5, int(dtype == torch.bfloat16),
                             int(dtype == torch.bfloat16), stream)
                    if err:
                        raise RuntimeError(f"ln_mlp launch failed: cudaError_t {err}")
                times = {}
                for name, old in olds.items():  # parent, kernel, kernel, parent
                    turns = [_time_ms(lambda fn=fn: call(fn), iters)
                             for fn in (old, kernel, kernel, old)]
                    for i, who in enumerate((name, "kernel", "kernel", name)):
                        times[f"{who} (turn {i + 1} of {name})"] = turns[i]
                    mine = out.clone()
                    call(kernel, out=mine)
                    call(old)
                    times[f"bit-equal to {name}"] = torch.equal(mine, out)
                times["kernel"] = _time_ms(lambda: call(kernel), iters)
                for (p, cut), fn in cuts.items():
                    if p == path:
                        times[cut] = _time_ms(lambda fn=fn: call(fn), iters)
                yield path, label, a, times


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--paths", nargs="+", choices=list(SITES), default=None,
                        help="the paths to time (default: all)")
    parser.add_argument("--parent", type=pathlib.Path, nargs="+", default=(),
                        help="other checkouts' csrc directories, timed against the kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlp_cuts needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [f"K5 with parts cut, ms a launch (mean of {args.iters}) [{card.splitlines()[0]}]"]
    print(lines[0], flush=True)
    for path, label, act, times in run(args.iters, args.paths, args.parent):
        cells = ", ".join(f"{k} {v}" if isinstance(v, bool) else f"{k} {v:.4f}"
                          for k, v in times.items())
        lines.append(f"{path} {label} site, act={act}: {cells}")
        print(lines[-1], flush=True)
    os.makedirs("outputs", exist_ok=True)
    with open("outputs/mlp_cuts.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
