"""Time the multi-head attention kernel (K1) stage by stage on the card, beside the card's
bound for each stage.

    python -m pcdiff_torch.scripts.attn_profile [--shapes z,read,write] [--iters N]
                                                [--device cuda|cpu]

Counterpart of ``scripts/attn_profile.py``. At the flagship's three attention shapes (B =
64 rows, the sampler's CFG batch; H = 8 heads of D = 32; bf16) each rung of the ladder
(:mod:`pcdiff_torch.ops.attn_ladder`, K8) is timed with CUDA events, the median of N runs
after a warm-up, beside its plain version and the card's bound for its work. Then ``full``
(K1 itself, :func:`pcdiff_torch.ops.fused_attention_mh`) and PyTorch's
scaled-dot-product attention on the same inputs, a yardstick the port never calls. The
difference between two rungs is the cost of the stage that the later one adds.

The bound of a rung is the largest of four times, one per unit of the card, since the
units run at once: its products over the bf16 tensor cores' 989 TFLOP/s; its
exponentials over the SFUs, 16 a clock on each of 132 SMs at the SM clock that
``nvidia-smi`` reports as ``clocks.max.sm``; its other softmax operations (a max, a
subtract, an add: one each a score) over the fp32 lanes, 128 a clock a SM; and the
inputs its output depends on read and o written once over 3.35 TB/s. The operations are
the rung's stage over every score, as K1 runs it; the bytes are q and o, k (only its
first D key rows for ``qk``, whose output is the first D key columns of S) and v (only
for ``nomax`` and ``full``, the rungs that multiply by it).

``--device cpu`` runs only the plain rungs at a tiny shape and prints no device time.
The JAX script's ``grid2`` rung has no counterpart (the reason is printed in its place).
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from ..ops import attn_ladder as al
from ..ops import flash_attention as fa

# The flagship's attention shapes at the sampler's CFG batch: (rows, Nq, Nk, H, H*D).
SHAPES = {
    "z": (64, 643, 643, 8, 256),       # latent self-attention, 24 of 36 sites a call
    "read": (64, 643, 1024, 8, 256),   # latents read the points, 6 sites
    "write": (64, 1024, 643, 8, 256),  # points read the latents, 6 sites
}
CPU_SHAPE = (2, 37, 131, 4, 128)  # the CPU tests' tiny shape, ragged both ways

# The H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
SMS = 132
SFU_PER_SM_CLOCK = 16
FP32_LANES_PER_SM = 128

# Work a score of each rung: (products of depth or width D, exponentials, other fp32 ops).
WORK = {
    "qk": (1, 0, 0),
    "qk_max": (1, 0, 1),      # + the max
    "qk_exp": (1, 1, 2),      # + the subtract and the exp
    "qk_sum": (1, 1, 3),      # + the add
    "nomax": (2, 1, 1),       # exp, add and P V; no max, no subtract
    "full": (2, 1, 3),        # K1: every stage
}
READS_V = ("nomax", "full")  # the rungs whose output depends on v
GRID2 = ("grid2: no counterpart. The TPU script's grid2 launches _mh_kernel over 4 heads a "
         "grid cell so that the blocks align to the TPU's 128 lanes; K1 already runs one "
         "head a block on the card.")


def card_bound(rung: str, rows: int, nq: int, nk: int, heads: int, hd: int,
               sm_clock_hz: float) -> dict:
    """The least time in ms of each of the card's units for ``rung``'s work, and
    ``bound_ms``/``bound_by``: the largest of them and its unit."""
    n_prod, n_exp, n_ops = WORK[rung]
    scores = rows * heads * nq * nk
    d = hd // heads
    k_rows = min(d, nk) if rung == "qk" else nk
    v_rows = nk if rung in READS_V else 0
    t = {
        "tensor": 1e3 * n_prod * 2.0 * scores * d / PEAK_BF16,
        "sfu": 1e3 * n_exp * scores / (SFU_PER_SM_CLOCK * SMS * sm_clock_hz),
        "fp32": 1e3 * n_ops * scores / (FP32_LANES_PER_SM * SMS * sm_clock_hz),
        "memory": 1e3 * 2.0 * rows * hd * (2 * nq + k_rows + v_rows) / PEAK_BYTES,
    }
    by = max(t, key=t.get)
    return dict(t, bound_ms=t[by], bound_by=by)


def card() -> dict:
    """The card's name, power limit and maximum SM clock, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power, clock = (f.strip() for f in out.split(","))
    return {"name": name, "power_limit": power, "sm_clock_hz": float(clock.split()[0]) * 1e6}


def inputs(rows: int, nq: int, nk: int, hd: int, device, seed: int = 0,
           dtype: torch.dtype = torch.bfloat16):
    """q (scaled as a pre-scaled query), k and v in ``dtype``, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(rows, nq, hd, generator=g, device=device) * (2 / math.sqrt(32))
    k = torch.randn(rows, nk, hd, generator=g, device=device)
    v = torch.randn(rows, nk, hd, generator=g, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _median_ms(fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sdpa(q, k, v, heads: int):
    def split(t):
        b, n, hd = t.shape
        return t.view(b, n, heads, hd // heads).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v), scale=1.0)


def profile(shapes, iters: int, sm_clock_hz: float) -> tuple:
    """(lines of the table, {shape: {rung: {"ms", "plain_ms", "bound_ms", "bound_by"}}}) on
    the card; ``full`` is K1 and ``sdpa`` the yardstick (times only)."""
    lines, res = [], {}
    for name in shapes:
        rows, nq, nk, heads, hd = SHAPES[name]
        q, k, v = inputs(rows, nq, nk, hd, "cuda")
        lines.append(f"== {name}: rows={rows} nq={nq} nk={nk} heads={heads} D={hd // heads} bf16 ==")
        lines.append(f"  {'rung':8s} {'kernel ms':>10s} {'plain ms':>10s} {'bound ms':>9s} "
                     f"{'x bound':>8s}  bound by (tensor / sfu / fp32 / memory ms)")
        res[name] = {}
        for rung in (*al.RUNGS, "full"):
            if rung == "full":
                ms = _median_ms(lambda: fa.fused_attention_mh(q, k, v, heads), iters)
                plain = _median_ms(lambda: fa._torch_attention_mh(q, k, v, heads), iters)
            else:
                ms = _median_ms(lambda: al.ladder(q, k, v, heads, rung), iters)
                plain = _median_ms(lambda: al._torch_ladder(q, k, v, heads, rung), iters)
            b = card_bound(rung, rows, nq, nk, heads, hd, sm_clock_hz)
            res[name][rung] = {"ms": ms, "plain_ms": plain, "bound_ms": b["bound_ms"],
                               "bound_by": b["bound_by"]}
            lines.append(f"  {rung:8s} {ms:10.4f} {plain:10.4f} {b['bound_ms']:9.4f} "
                         f"{ms / b['bound_ms']:8.2f}  {b['bound_by']} ({b['tensor']:.4f} / "
                         f"{b['sfu']:.4f} / {b['fp32']:.4f} / {b['memory']:.4f})")
        sdpa = _median_ms(lambda: _sdpa(q, k, v, heads), iters)
        res[name]["sdpa"] = {"ms": sdpa}
        lines.append(f"  {'sdpa':8s} {sdpa:10.4f}  (PyTorch's scaled_dot_product_attention, "
                     f"a yardstick for full)")
        lines.append(f"  {GRID2}")
    return lines, res


def profile_cpu() -> list:
    """One line per rung: the plain versions at the tiny shape on the CPU."""
    rows, nq, nk, heads, hd = CPU_SHAPE
    q, k, v = inputs(rows, nq, nk, hd, "cpu")
    lines = [f"== cpu: rows={rows} nq={nq} nk={nk} heads={heads} D={hd // heads}: plain "
             f"versions only, host clock, no device time =="]
    for rung in al.RUNGS:
        t0 = time.perf_counter()
        out = al.ladder(q, k, v, heads, rung)
        ms = 1e3 * (time.perf_counter() - t0)
        lines.append(f"  {rung:8s} plain {ms:.3f} ms on the CPU, output "
                     f"{tuple(out.shape)} {str(out.dtype)[6:]}, mean |o| "
                     f"{out.float().abs().mean().item():.4f}")
    lines.append(f"  {GRID2}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="z,read,write")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cpu":
        print("\n".join(profile_cpu()))
        return
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card: torch.cuda.is_available() is False")
    shapes = args.shapes.split(",")
    unknown = sorted(set(shapes) - set(SHAPES))
    if unknown:
        raise SystemExit(f"unknown shapes {unknown}; known: {sorted(SHAPES)}")
    c = card()
    print(f"card: {c['name']}, {c['power_limit']}, max SM clock {c['sm_clock_hz'] / 1e6:.0f} MHz "
          f"({torch.cuda.get_device_name(0)}); median of {args.iters} runs after a warm-up")
    lines, _ = profile(shapes, args.iters, c["sm_clock_hz"])
    print("\n".join(lines))


if __name__ == "__main__":
    main(sys.argv[1:])
