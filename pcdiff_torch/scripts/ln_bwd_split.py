"""K4's card time split by device kernel at the train step's LN -> projection sites.

K4 (``csrc/ln_dense_bwd.cu``, behind ``ops.ln_dense._launch_bwd``) is one call of several
device kernels. This script times each of them at every fp32 site of the train step
(``chip_smoke.TRAIN_LN_SITES``: rows, outputs, activation and launches a step), under
``torch.profiler``, over ``--iters`` calls after two warm-up ones, and prints the device time of
each kernel a call and summed over a step; ``--out`` gets the same table. Run it on a CUDA card
from the root of a checkout:

    python -m pcdiff_torch.scripts.ln_bwd_split [--iters 10] [--out outputs/ln_bwd_split.txt]

It reaches the kernels only through ``_launch_bwd`` and the site table, so it runs against any
version of K4 behind that wrapper.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import torch


def kernel_name(key: str) -> str:
    """The profiler's kernel name cut to its identifier: ``void (anonymous
    namespace)::ln_denses_bwd_dy_kernel<float>(...)`` -> ``ln_denses_bwd_dy_kernel``."""
    m = re.search(r"(\w*ln_denses\w*|sum_partials|\w+)(?=<|\()", key)
    return m.group(1) if m else key


def split(site, iters: int) -> dict:
    """{kernel: device ms a call} of K4 at one site, fp32."""
    import chip_smoke as cs
    from pcdiff_torch.ops import ln_dense as ld
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label, rows, n, fs, act, _, _ = site
    g = torch.Generator(device=cs.DEV).manual_seed(0)
    x, scale, bias, ws, bs, gs = cs._ln_bwd_inputs(g, rows, n, cs.HD, fs, torch.float32)
    args = (x, scale, bias, ws, bs, gs, 1e-5, torch.float32, [act] * len(fs))
    for _ in range(2):
        ld._launch_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            ld._launch_bwd(*args)
        torch.cuda.synchronize()
    times: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = kernel_name(ev.key)
        times[name] = times.get(name, 0.0) + ev.self_device_time_total / 1e3 / iters
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="outputs/ln_bwd_split.txt")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ln_bwd_split needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    lines, step = [], {}
    for site in cs.TRAIN_LN_SITES:
        label, rows, n, fs, act, _, per_step = site
        times = split(site, opts.iters)
        for name, ms in times.items():
            step[name] = step.get(name, 0.0) + per_step * ms
        parts = ", ".join(f"{name} {ms:.4f}" for name, ms in
                          sorted(times.items(), key=lambda kv: -kv[1]))
        lines.append(f"{label} [{rows}x{n}->{'+'.join(map(str, fs))}] act={act} x{per_step}: "
                     f"{sum(times.values()):.4f} ms a call ({parts})")
    total = sum(step.values())
    lines.append(f"per train step: {total:.3f} ms; " + ", ".join(
        f"{name} {ms:.3f} ({100 * ms / total:.1f}%)"
        for name, ms in sorted(step.items(), key=lambda kv: -kv[1])))
    lines.append(f"card: {cs.device_line()}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
