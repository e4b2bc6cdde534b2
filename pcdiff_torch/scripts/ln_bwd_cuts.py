"""Time K4's bf16 path on the card with parts of its work cut at compile time.

    python -m pcdiff_torch.scripts.ln_bwd_cuts [--iters N] [--out outputs/ln_bwd_cuts.txt]

Each cut is a copy of ``csrc/ln_dense_bwd.cu`` with one piece of the bf16 path's work removed
by a textual substitution (:data:`CUTS`), built by ``nvcc`` as the kernel itself is
(``ops/_native.py``'s flags, into ``build/pcdiff_torch/cuts``) and timed with CUDA events
through ``ops.ln_dense._launch_bwd`` (its bf16 entry point swapped for the cut's) at four of
the train step's LN -> projection sites (``chip_smoke.TRAIN_LN_SITES``): the z stream's qkv,
q and fc1 sites and the x stream's fc1 site, in bf16. The kernel's time less a cut's is what
the cut piece costs where it does not overlap the rest of the work. A cut's output is wrong
by design: only its time is read. The substitutions must match the source exactly, so the
script (and a CPU test) fails when the kernel changes under them. The table is printed and
written to ``--out``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from ..ops import _native
from ..ops import ln_dense as ld

# the bf16 path's pieces, as they stand in csrc/ln_dense_bwd.cu
_ACT_GRAD = ("q[h][e] = __fmul_rn(gv[h][e], pcdiff_ln::act_grad<ACT>(z[h][e], div));")
_GZ_DB = "  float* db = ga.db_part[o];\n"
_GZ_G = "      gv[h][0] = __low2float(v);\n      gv[h][1] = __high2float(v);"
_LN_BWD = "  ln_backward<TX>(a, rt, acc, sx, stats, red);"
_DY_DB = "    db_stage(a, rt, s, slot);\n"

# cut name -> substitutions (old, new)
CUTS = {
    "gz: no act'": [(_ACT_GRAD, "q[h][e] = __fmul_rn(gv[h][e], z[h][e]);")],
    "gz: no db": [(_GZ_DB, "  float* db = nullptr;\n")],
    "gz: no g loads": [(_GZ_G, "      gv[h][0] = 1.f;\n      gv[h][1] = 1.f;")],
    "dy: no LN backward": [(_LN_BWD, "  if (acc[0] == 12345.f) a.ln_part[0] = acc[1] + acc[127] "
                                     "+ stats[0].x + red[0] + (float)sx[0];")],
    "dy: no g column sums": [(_DY_DB, "")],
}
SITES = ("compute qkv (z)", "read q (z)", "compute fc1 (z)", "write fc1 (x)")
CUT_DIR = _native.BUILD_DIR / "cuts"


def cut_source(name: str) -> str:
    """``csrc/ln_dense_bwd.cu`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "ln_dense_bwd.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in ln_dense_bwd.cu once")
        text = text.replace(old, new)
    return text


def _build_cuts(argtypes) -> dict:
    """Every cut built at once, one nvcc each; {name: its bf16 entry point}."""
    CUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(CUTS):
        src = CUT_DIR / f"ln_dense_bwd_cut{i}.cu"
        src.write_text(cut_source(name))
        lib = CUT_DIR / f"libln_dense_bwd_cut{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on cut {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).pcdiff_ln_denses_bwd_bf16
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def run(iters: int = 20) -> list:
    """Rows (site, {"kernel": ms, cut name: ms}): each time a call, in the order kernel,
    cuts, cuts again in reverse, kernel again, each entry the mean of its two readings."""
    import chip_smoke as cs

    kernel = ld._bwd_kernel_fn("bf16")
    entries = {"kernel": kernel, **_build_cuts(kernel.argtypes)}
    order = list(entries) + list(entries)[::-1]
    g = torch.Generator(device=cs.DEV).manual_seed(0)
    rows = []
    try:
        for label, b, n, fs, act, _, per_step in cs.TRAIN_LN_SITES:
            if label not in SITES:
                continue
            x, scale, bias, ws, bs, gs = cs._ln_bwd_inputs(g, b, n, cs.HD, fs, torch.bfloat16)
            args = (x, scale, bias, ws, bs, gs, 1e-5, torch.bfloat16, [act] * len(fs))
            times: dict = {}
            for name in order:
                ld._bwd_fns["bf16"] = entries[name]
                times.setdefault(name, []).append(cs._time_ms(lambda: ld._launch_bwd(*args),
                                                              iters))
            rows.append((label, per_step, {k: sum(v) / len(v) for k, v in times.items()}))
    finally:
        ld._bwd_fns["bf16"] = kernel
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="outputs/ln_bwd_cuts.txt")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ln_bwd_cuts needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    lines = []
    for label, per_step, t in run(opts.iters):
        k = t["kernel"]
        cuts = ", ".join(f"{name} {ms:.4f} ({ms - k:+.4f})" for name, ms in t.items()
                         if name != "kernel")
        lines.append(f"{label} x{per_step}: K4 bf16 {k:.4f} ms a call; {cuts}")
    lines.append(f"card: {cs.device_line()}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
