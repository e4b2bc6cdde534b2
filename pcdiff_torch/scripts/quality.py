"""Train and evaluate ``configs/synthetic_quality.yaml`` with the port's drivers, end to end.

Writes the config's fixture with the port's builder, as ``scripts/make_quality_fixture.py``
writes it for the JAX package (``make_modelnet_fixture``, seed 7, 5 classes x 4 instances x
4 scans, 256 points, 64² depth maps), but as ``.npz``; trains it with
``pcdiff_torch.cli.train`` (400 epochs of 5 steps at B = 16), evaluates the checkpoint with
``pcdiff_torch.cli.evaluate`` (64 Karras steps, CFG 3, per-class CD and F1 over the 80
scans) and writes ``quality.json`` (the summary, the wall times, the card), the run's
``metrics.jsonl`` and the evaluation log to ``--out``; the fixture and the checkpoints stay
in a temporary directory. On a CUDA card, from the root of a checkout:

    python -m pcdiff_torch.scripts.quality [--out outputs/quality] [key.path=value ...]

``--device cpu`` runs the plain versions (with overrides that shrink the run, as a test).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "synthetic_quality.yaml")
FIXTURE = dict(instances_per_class=4, scans_per_instance=4, num_points=256, depth_size=64,
               seed=7)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="outputs/quality")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from pcdiff_torch.cli import evaluate, train
    from pcdiff_torch.core.config import load_config
    from pcdiff_torch.core.device import resolve_device
    from pcdiff_torch.data import make_modelnet_fixture

    dev = resolve_device(args.device)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="pcdiff_quality_")  # fixture and checkpoints
    fixture = os.path.join(work.name, "pcdiff_quality.npz")
    make_modelnet_fixture(fixture, **FIXTURE)

    t0 = time.perf_counter()
    cfg = load_config(CONFIG, [f"data.h5_path={fixture}", f"train.output_dir={work.name}",
                               *args.overrides])
    run = train.main(cfg, device=dev)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(out)  # the evaluation log goes beside the summary
    try:
        summary = evaluate.main(load_config(CONFIG, [
            f"data.h5_path={fixture}",
            f"sample.load_checkpoint_path={run['run_dir']}/checkpoints", *args.overrides]),
            device=dev)
    finally:
        os.chdir(cwd)
    evaluate_s = time.perf_counter() - t0

    shutil.copy(os.path.join(run["run_dir"], "metrics.jsonl"),
                os.path.join(out, "train_metrics.jsonl"))
    work.cleanup()
    steps = sum(e["steps"] for e in run["epochs"])
    result = dict(
        config="configs/synthetic_quality.yaml", overrides=list(args.overrides),
        fixture=FIXTURE, device=str(dev),
        card=card() if dev.type == "cuda" else "cpu",
        steps=steps, train_s=train_s,
        ms_per_step=1e3 * sum(e["step_seconds"] for e in run["epochs"]) / max(steps, 1),
        # the median epoch's, past the first (which builds the kernels)
        ms_per_step_median=1e3 * float(np.median(
            [e["step_seconds"] / e["steps"] for e in run["epochs"][1:] or run["epochs"]])),
        first_loss=run["epochs"][0]["loss"], last_loss=run["epochs"][-1]["loss"],
        evaluate_s=evaluate_s, summary=summary,
        evaluation_log=[os.path.basename(p) for p in
                        glob.glob(os.path.join(out, "evaluation_log_*.txt"))])
    with open(os.path.join(out, "quality.json"), "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(json.dumps({k: result[k] for k in ("card", "steps", "train_s", "ms_per_step",
                                             "ms_per_step_median", "evaluate_s")}))
    print(json.dumps(summary["overall"], default=float))
    return result


if __name__ == "__main__":
    main()
