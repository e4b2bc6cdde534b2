"""Score one trained run of the port under each sampling lever.

The port's counterpart of ``scripts/trained_gates.py``: the same registry of gate rows
(``GATES``: the step counts, bf16 activations, Picard tolerances, past-score reuse, the
bf16 exponentials, guidance-interval CFG, tanh GELU, ``scan_blocks`` and the EMA shadow),
each scored by :func:`pcdiff_torch.cli.evaluate.main` on the held-out file, and the same
row format (:func:`make_gate_row`). Each row is written to ``dest`` as soon as it is
scored, so a cut run loses only the row in flight; ``--skip-done`` resumes it. An EMA row
restores ``run_dir/ema``; a run trained without an EMA shadow (``train.ema_decay`` 0, as
``configs/synthetic_shapes.yaml``) has none, and the row is recorded as skipped with the
reason. Every scored row also holds the card and its evaluation's seconds.

``model.scan_blocks`` has no effect in the port (one parameter layout), so
``bf16-gi-reuse-scan`` runs the program of ``bf16-gi-reuse`` with the same seed: the two
rows must be equal.

On a CUDA card, from the root of a checkout, after
``python -m pcdiff_torch.scripts.shapes_evidence``::

    python -m pcdiff_torch.scripts.trained_gates <run_dir> [config] [test_data]
        [--only=g1,g2] [--dest=path.json] [--skip-done] [--device cuda|cpu]

``config`` defaults to ``configs/synthetic_shapes.yaml``, ``test_data`` to the held-out
fixture that ``shapes_evidence`` wrote beside the run (``<work>/shapes_test.npz`` for
``run_dir`` = ``<work>/runs/run_*``), ``dest`` to ``<run_dir>/trained_gates.json``. The
evaluation logs go to ``dest``'s directory and are removed at the end (the JSON is the
record).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Iterable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "synthetic_shapes.yaml")

# (name, overrides[, "ema"]), in the JAX package's order and with its override strings
GATES = [
    # 64-step fp32 heun: the shapes evidence's "trained_heldout", scored in the harness
    ("baseline", []),
    ("steps-48", ["sample.karras_steps=48"]),
    ("steps-32", ["sample.karras_steps=32"]),
    ("steps-24", ["sample.karras_steps=24"]),
    ("steps-16", ["sample.karras_steps=16"]),
    ("bf16", ["model.compute_dtype=bfloat16"]),
    # decimal literals, as the JAX package writes them (PyYAML reads a bare 1e-3 as a str)
    ("picard-1e-3", ["sample.sampler=heun_parallel",
                     "sample.parallel_window=8", "sample.parallel_tol=0.001"]),
    ("picard-1e-2", ["sample.sampler=heun_parallel",
                     "sample.parallel_window=8", "sample.parallel_tol=0.01"]),
    # past-score reuse: 65 denoiser calls at 64 steps against heun's 127
    ("reuse-64", ["sample.sampler=heun_reuse"]),
    ("reuse-32", ["sample.sampler=heun_reuse", "sample.karras_steps=32"]),
    # the attention's exponentials in bf16 (off K1's domain, head dim 16: the XLA twin's
    # function, as in the JAX package)
    ("softmax-bf16", ["model.compute_dtype=bfloat16",
                      "model.softmax_dtype=bfloat16"]),
    ("bf16-reuse", ["model.compute_dtype=bfloat16",
                    "sample.sampler=heun_reuse"]),
    # guidance-interval CFG (arXiv:2404.07724): the unconditional branch only while sigma
    # is in [lo, hi]
    ("gi-reuse", ["sample.sampler=heun_reuse",
                  "sample.guidance_interval_lo=0.1",
                  "sample.guidance_interval_hi=10.0"]),
    ("gi-wide-reuse", ["sample.sampler=heun_reuse",
                       "sample.guidance_interval_lo=0.05",
                       "sample.guidance_interval_hi=25.0"]),
    ("bf16-gi-reuse", ["model.compute_dtype=bfloat16",
                       "sample.sampler=heun_reuse",
                       "sample.guidance_interval_lo=0.1",
                       "sample.guidance_interval_hi=10.0"]),
    ("gi-narrow-reuse", ["sample.sampler=heun_reuse",
                         "sample.guidance_interval_lo=0.28",
                         "sample.guidance_interval_hi=5.42"]),
    ("bf16-gi-narrow-reuse", ["model.compute_dtype=bfloat16",
                              "sample.sampler=heun_reuse",
                              "sample.guidance_interval_lo=0.28",
                              "sample.guidance_interval_hi=5.42"]),
    # the whole fast stack at half the sigma grid, gated as a unit
    ("bf16-gi-reuse-32", ["model.compute_dtype=bfloat16",
                          "sample.sampler=heun_reuse",
                          "sample.karras_steps=32",
                          "sample.guidance_interval_lo=0.1",
                          "sample.guidance_interval_hi=10.0"]),
    # tanh-approximated GELU in the transformer MLPs, on the default program
    ("bf16-gi-reuse-gelutanh", ["model.compute_dtype=bfloat16",
                                "model.gelu_impl=tanh",
                                "sample.sampler=heun_reuse",
                                "sample.guidance_interval_lo=0.1",
                                "sample.guidance_interval_hi=10.0"]),
    # the JAX package's scan over the blocks; without effect here, so bf16-gi-reuse's twin
    ("bf16-gi-reuse-scan", ["model.compute_dtype=bfloat16",
                            "model.scan_blocks=true",
                            "sample.sampler=heun_reuse",
                            "sample.guidance_interval_lo=0.1",
                            "sample.guidance_interval_hi=10.0"]),
    # the EMA shadow (run_dir/ema), on the fp32 baseline and on the fast stack
    ("ema-baseline", [], "ema"),
    ("ema-bf16-gi-reuse", ["model.compute_dtype=bfloat16",
                           "sample.sampler=heun_reuse",
                           "sample.guidance_interval_lo=0.1",
                           "sample.guidance_interval_hi=10.0"], "ema"),
]


def make_gate_row(summary: dict, overrides: list, run_dir: str) -> dict:
    """One gate row from a :func:`pcdiff_torch.cli.evaluate.main` summary: the overall and
    per-class CD and F1, the run directory's name and the row's overrides (the JAX
    package's row format)."""
    o = summary["overall"]
    return {
        "cd_full": o["cd_full"], "f1_full": o["f1_full"],
        "per_class": {
            cls: {"cd_full": v["cd_full"], "f1_full": v["f1_full"]}
            for cls, v in summary["per_class"].items()
        },
        "checkpoint": os.path.basename(os.path.normpath(run_dir)),
        "overrides": overrides,
    }


def default_test_data(run_dir: str) -> str:
    """The held-out fixture that ``shapes_evidence`` writes beside ``run_dir``."""
    from .shapes_evidence import TEST_FILE

    work = os.path.dirname(os.path.dirname(os.path.abspath(os.path.normpath(run_dir))))
    return os.path.join(work, TEST_FILE)


def _has_checkpoint(directory: str) -> bool:
    from ..core.checkpoint import latest_checkpoint_step

    return os.path.isdir(directory) and latest_checkpoint_step(directory) is not None


def _write(dest: str, results: dict) -> None:
    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=2)
    os.replace(tmp, dest)


def main(run_dir: str, config_path: str = CONFIG, test_data: Optional[str] = None,
         only: Optional[Iterable[str]] = None, dest: Optional[str] = None,
         skip_done: bool = False, device="cuda") -> dict:
    """Score ``run_dir``'s checkpoint under each row of ``GATES`` (those in ``only``, if
    given) on ``device`` and write the rows to ``dest``; returns them. With ``only`` or
    ``skip_done`` the rows already in ``dest`` are kept, and with ``skip_done`` they are
    not scored again."""
    from ..cli import evaluate
    from ..core.config import apply_overrides, load_config
    from ..core.device import resolve_device
    from .quality import card

    dev = resolve_device(device)
    run_dir = os.path.abspath(run_dir)  # the evaluations run in dest's directory
    only = set(only) if only else None
    test_data = os.path.abspath(test_data or default_test_data(run_dir))
    dest = os.path.abspath(dest or os.path.join(run_dir, "trained_gates.json"))
    base = load_config(config_path, [])
    name = card() if dev.type == "cuda" else "cpu"
    results = {}
    if (only or skip_done) and os.path.exists(dest):
        with open(dest) as f:
            results = json.load(f)  # merge the new rows into the record
    out_dir = os.path.dirname(dest)
    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)  # each evaluation writes its log to the working directory
    try:
        logs_before = set(glob.glob("evaluation_log_*.txt"))
        for row in GATES:
            gate, overrides = row[0], row[1]
            use_ema = len(row) > 2 and row[2] == "ema"
            if only and gate not in only:
                continue
            if skip_done and gate in results:
                print(f"=== {gate} === (already in {dest}, skipped)", flush=True)
                continue
            ckpt = os.path.join(run_dir, "ema" if use_ema else "checkpoints")
            if use_ema and not _has_checkpoint(ckpt):
                results[gate] = dict(
                    skipped=f"no EMA shadow: {os.path.basename(run_dir)}/ema holds no "
                            "checkpoint (the run trained with train.ema_decay = 0)",
                    checkpoint=os.path.basename(os.path.normpath(run_dir)),
                    overrides=overrides, ema_params=True)
                print(f"=== {gate} === skipped: {results[gate]['skipped']}", flush=True)
                _write(dest, results)
                continue
            cfg = apply_overrides(base, [f"data.h5_path={test_data}",
                                         f"sample.load_checkpoint_path={ckpt}", *overrides])
            print(f"=== {gate} ===", flush=True)
            t0 = time.perf_counter()
            out = evaluate.main(cfg, device=dev)
            results[gate] = make_gate_row(out, overrides, run_dir)
            if use_ema:
                results[gate]["ema_params"] = True
            results[gate].update(card=name, seconds=time.perf_counter() - t0)
            print(f"{gate}: cd={out['overall']['cd_full']:.6f} "
                  f"f1={out['overall']['f1_full']:.6f}", flush=True)
            _write(dest, results)  # after every row: a cut run resumes with skip_done
        for log in set(glob.glob("evaluation_log_*.txt")) - logs_before:
            os.remove(log)  # the per-row logs are scratch; the JSON is the record
    finally:
        os.chdir(cwd)
    _write(dest, results)
    print(f"wrote {dest}")
    return results


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir")
    parser.add_argument("config", nargs="?", default=CONFIG)
    parser.add_argument("test_data", nargs="?", default=None)
    parser.add_argument("--only", default=None, help="comma-separated gate names")
    parser.add_argument("--dest", default=None)
    parser.add_argument("--skip-done", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, for the plain PyTorch versions")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.run_dir, args.config, args.test_data,
         only=args.only.split(",") if args.only else None, dest=args.dest,
         skip_done=args.skip_done, device=args.device)
