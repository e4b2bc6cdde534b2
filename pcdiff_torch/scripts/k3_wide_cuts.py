"""Time K3's wide rows (``csrc/ln_dense.cu``, 256 < C <= 1024) on the card with parts of their
work cut at compile time.

    python -m pcdiff_torch.scripts.k3_wide_cuts [--iters N]

Each cut is a copy of ``csrc/ln_dense.cu`` with one piece of the wide kernel's work removed by
a textual substitution (:data:`CUTS`), built by ``nvcc`` as the kernel itself is
(``ops/_native.py``'s flags, into ``build/pcdiff_torch/k3_wide_cuts``) and timed with CUDA
events at the Point-E path's sites (``chip_smoke.PE_LN_SITES``: the upsampler's and base40M's
qkv and fc1 at C = 512, the CLIP towers' at 768 and 1024), in the dtype of the cut's path, beside
the kernel itself. The kernel's time less a cut's is what the cut piece costs where it does
not overlap the rest of the work. A cut's output is wrong by design: only its time is read.
The substitutions must match the source exactly, so the script (and a CPU test) fails when the
kernel changes under them. The table is printed and written to ``outputs/k3_wide_cuts.txt``,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess

import torch

from ..ops import _native
from ..ops import ln_dense as ld
from .mlp_cuts import _time_ms

# the kernel's pieces, as they stand in csrc/ln_dense.cu (the panel's normalisation and the
# 3xTF32 product are ln_wide.cuh's, cut at their calls)
_NORMALISE = "    panel<TX, TO, PR>(a, bk.r0, sa, xbar, kx);\n"
_X_ONLY = "    if constexpr (std::is_same<TX, TO>::value) mbar_wait(xbar, 0);\n"
_WGMMA = ("        wgmma_m64k16<N>(acc, sw128_desc(as + 16 * ks), sw128_desc(ws + 16 * ks),\n"
          "                        kc > 0 || ks > 0);")
_EPILOGUE_BF16 = "    n0 += PR == 128 ? 0 : wg * (BN / 2);\n"
_TF32 = ("      stage_3xtf32<MT>(acc, sa + kc * (PR * BK), ring + (s % STAGES) * "
         "(STAGE_BYTES / 4));")
_3XTF32 = "      for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], ahi[mt], alo[mt], bhi, blo);"
_1XTF32 = "      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ahi[mt], bhi[0], bhi[1]);"
_EPILOGUE_FP32 = "    const int o = pcdiff_ln::tile_output<float>(a, t, n0);\n"

# (path, cut name) -> substitutions (old, new)
CUTS = {
    # the panel's x arrives, is not normalised
    ("bf16", "no normalise"): [(_NORMALISE, _X_ONLY)],
    ("bf16", "no products"): [(_WGMMA, "        ;")],
    ("bf16", "no epilogue"): [(_EPILOGUE_BF16, _EPILOGUE_BF16 + "    if (a.rows > 0) continue;\n")],
    ("fp32", "no normalise"): [(_NORMALISE, _X_ONLY)],
    ("fp32", "no products"): [(_TF32, "      (void)kc;")],
    ("fp32", "1xTF32"): [(_3XTF32, _1XTF32)],
    ("fp32", "no epilogue"): [(_EPILOGUE_FP32, _EPILOGUE_FP32 + "    if (a.rows > 0) continue;\n")],
}
PATHS = {"bf16": torch.bfloat16, "fp32": torch.float32}
CUT_DIR = _native.BUILD_DIR / "k3_wide_cuts"


def cut_source(name: tuple) -> str:
    """``csrc/ln_dense.cu`` with cut ``name``'s substitutions (each must match once)."""
    text = (_native.CSRC_DIR / "ln_dense.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"cut {name}: {old!r} is not in ln_dense.cu once")
        text = text.replace(old, new)
    return text


def _build_cuts() -> dict:
    """Every cut built at once, one nvcc each; {name: the loaded entry point}."""
    CUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(CUTS):
        src = CUT_DIR / f"ln_dense_cut{i}.cu"
        src.write_text(cut_source(name))
        lib = CUT_DIR / f"libln_dense_cut{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernel = ld._kernel_fn()
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on cut {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).pcdiff_ln_denses_fwd
        fn.argtypes, fn.restype = kernel.argtypes, kernel.restype
        fns[name] = fn
    return fns


def run(iters: int = 20) -> list:
    """Rows (path, site, {"kernel": ms, cut name: ms})."""
    from chip_smoke import PE_LN_SITES  # the path's sites; the repo root is on the path

    kernel = ld._kernel_fn()
    cuts = _build_cuts()
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for label, n, c, fs, act, _ in PE_LN_SITES:
        for path, dtype in PATHS.items():
            x = (torch.randn(n, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
            args = (x, 1 + 0.1 * torch.randn(c, generator=g, device=dev),
                    0.1 * torch.randn(c, generator=g, device=dev),
                    [torch.randn(f, c, generator=g, device=dev) / math.sqrt(c) for f in fs],
                    [0.1 * torch.randn(f, generator=g, device=dev) for f in fs], 1e-5, dtype,
                    [act] * len(fs))
            times = {}
            try:
                for name, fn in [("kernel", kernel)] + [(cut, fn) for (p, cut), fn in
                                                        cuts.items() if p == path]:
                    ld._fn = fn
                    times[name] = _time_ms(lambda: ld._launch(*args), iters)
            finally:
                ld._fn = kernel
            rows.append((path, label, times))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_wide_cuts needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [f"K3 wide rows with parts cut, ms a launch (mean of {args.iters}) "
             f"[{card.splitlines()[0]}]"]
    for path, label, times in run(args.iters):
        cells = ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        lines.append(f"{path} {label}: {cells}")
    print("\n".join(lines))
    os.makedirs("outputs", exist_ok=True)
    with open("outputs/k3_wide_cuts.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
