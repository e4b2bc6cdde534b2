"""Time K1's one-pass bf16 exp mode on the card with parts of its work cut at compile time.

    python -m pcdiff_torch.scripts.exp_cuts [--iters N] [--out outputs/exp_cuts.txt]

Each cut is a copy of ``csrc/attention_fwd.cuh`` with one piece of ``exp_block``'s work
removed by a textual substitution (:data:`CUTS`), built with ``csrc/attention_mh.cu`` by
``nvcc`` as the kernel itself is (``ops/_native.py``'s flags, into
``build/pcdiff_torch/exp_cuts``) and timed with CUDA events through
``ops.flash_attention._launch`` under the bf16 exp switch (its entry point swapped for the
cut's) at the sampler's three backbone shapes (``chip_smoke.ATTN_SHAPES``, bf16). The
kernel's time less a cut's is what the cut piece costs where it does not overlap the rest
of the work. A cut's output is wrong by design: only its time is read. The substitutions
must match the source exactly, so the script (and a CPU test) fails when the kernel changes
under them. The table is printed and written to ``--out``, with the card's name and power
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

# exp_block's pieces, as they stand in csrc/attention_fwd.cuh
_EXP = ("            const unsigned pp = pack_bf16(ex2(bf16_lo(t) * LOG2E), "
        "ex2(bf16_hi(t) * LOG2E));\n")
_MAX_SYNC = "    group_sync();  // the group's maxes are written\n"
_MAX_READ = "        if (j < splits) x = fmaxf(x, smax[(grp * splits + j) * 16 + g + 8 * r]);\n"
_REDUCE = "      if (16 * tile + row >= p.nq) break;\n"

# cut name -> substitutions (old, new)
CUTS = {
    "no exp": [(_EXP, "            const unsigned pp = t;\n")],
    "no max exchange": [(_MAX_SYNC, ""), (_MAX_READ, "        x = m[r];\n")],
    "no partial sums": [(_REDUCE, "      break;\n")],
}
CUT_DIR = _native.BUILD_DIR / "exp_cuts"


def cut_source(name: str) -> str:
    """``csrc/attention_fwd.cuh`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "attention_fwd.cuh").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in attention_fwd.cuh once")
        text = text.replace(old, new)
    return text


def _build_cuts(argtypes) -> dict:
    """Every cut built at once, one nvcc each, the cut's header beside its copy of
    ``attention_mh.cu``; {name: its entry point}."""
    procs = {}
    for i, name in enumerate(CUTS):
        d = CUT_DIR / f"cut{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention_fwd.cuh").write_text(cut_source(name))
        src = d / "attention_mh.cu"
        src.write_text((_native.CSRC_DIR / "attention_mh.cu").read_text())
        lib = d / "libattention_mh.so"
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on cut {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).pcdiff_attention_mh_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def run(iters: int = 20) -> list:
    """Rows (label, per-call launches, plan, {"kernel": ms, cut name: ms}): each time a
    call, in the order kernel, cuts, cuts again in reverse, kernel again, each entry the
    mean of its two readings."""
    import chip_smoke as cs

    kernel = fa._kernel_fn()
    entries = {"kernel": kernel, **_build_cuts(kernel.argtypes)}
    order = list(entries) + list(entries)[::-1]
    g = torch.Generator(device=cs.DEV).manual_seed(0)
    rows = []
    fa.set_attention_softmax_dtype("bfloat16")
    try:
        for label, b, nq, nk, per_call in cs.ATTN_SHAPES:
            if not per_call:
                continue
            q = (torch.randn(b, nq, cs.HD, generator=g, device=cs.DEV) * 0.35).bfloat16()
            k, v = (torch.randn(b, nk, cs.HD, generator=g, device=cs.DEV).bfloat16()
                    for _ in range(2))
            times: dict = {}
            for name in order:
                fa._fn = entries[name]
                times.setdefault(name, []).append(cs._time_ms(lambda: fa._launch(q, k, v, 8),
                                                              iters))
            rows.append((f"{label} [{b}x{nq}x{nk}]", per_call, fa._exp_plan(nk),
                         {k_: sum(t) / len(t) for k_, t in times.items()}))
    finally:
        fa._fn = kernel
        fa.set_attention_softmax_dtype("float32")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="outputs/exp_cuts.txt")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_cuts needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    lines = []
    for label, per_call, plan, t in run(opts.iters):
        k = t["kernel"]
        cuts = ", ".join(f"{name} {ms:.4f} ({ms - k:+.4f})" for name, ms in t.items()
                         if name != "kernel")
        lines.append(f"{label} x{per_call}, {plan[0]} warps of {plan[1]} keys: K1 bf16 exp "
                     f"{k:.4f} ms a call; {cuts}")
    lines.append(f"card: {cs.device_line()}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
