"""Train the port on parametric shapes and score it on instances it never saw.

The port's counterpart of ``scripts/shapes_evidence.py``. It writes the shapes fixtures
with the port's fixture writer (:func:`pcdiff_torch.data.make_shapes_fixture`, as
``.npz``: the train file from seed 0 with 32 instances a class, the held-out file from seed
9 with 4, so the two draw disjoint instances), trains ``configs/synthetic_shapes.yaml`` on
the train file with :func:`pcdiff_torch.cli.train.main`, and scores with
:func:`pcdiff_torch.cli.evaluate.main` on the held-out file:

1. ``trained_heldout``: the trained checkpoint (64 Karras steps, fp32 heun, CFG 3);
2. ``untrained``: a fresh initialisation from a torch generator seeded 123, saved as a
   train state with the port's checkpoint code: the noise floor;
3. ``partial_copy``: the clamped partial scan echoed as the prediction, through
   ``CompletionMetrics``: the trivial competitor;

and the trained checkpoint again at each sampling seed of ``--seeds`` (``train.seed`` set
in the evaluation only; the training's seed is the config's), beside ``trained_heldout``'s
seed: the gate's noise floor. The record (``--dest``, by default
``<work>/shapes_evidence.json``) holds the three rows in the JAX package's layout
(``overall``, ``per_class``), the seeds' rows under ``sampling_seeds``, and under ``run``
the card (name and power limit), the config, the overrides, the fixtures, the steps, the
train wall, ms/step and each evaluation's wall. The evaluation logs go to the record's
directory (``evaluation_log_shapes.txt``, ``evaluation_log_shapes_untrained.txt``).

The fixtures, the run (``<work>/runs/run_*``) and the fresh checkpoint stay in ``--work``
(a new temporary directory unless given), where ``trained_gates`` finds the held-out
file beside the run. On a CUDA card, from the root of a checkout::

    python -m pcdiff_torch.scripts.shapes_evidence [run_dir|-] [key.path=value ...]
        [--work DIR] [--dest PATH] [--seeds 0,1] [--device cuda|cpu]
    python -m pcdiff_torch.scripts.trained_gates <work>/runs/run_* --dest=...

A ``run_dir`` skips the train fixture and the training. ``--instances`` (train,test
instances a class) shrinks the fixtures, with ``--device cpu`` and overrides, for a
rehearsal.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "synthetic_shapes.yaml")
TRAIN_FILE = "shapes_train.npz"
TEST_FILE = "shapes_test.npz"
TRAIN_SEED, TEST_SEED = 0, 9  # disjoint instances
INSTANCES = (32, 4)  # a class: train, held out
UNTRAINED_SEED = 123
SAMPLING_SEEDS = (0, 1)


def make_fixture(work: str, split: str, instances_per_class: int) -> str:
    """Write the ``split`` ("train" or "test") shapes fixture into ``work``; its path."""
    from ..data import make_shapes_fixture

    path = os.path.join(work, TRAIN_FILE if split == "train" else TEST_FILE)
    return make_shapes_fixture(path, instances_per_class=instances_per_class,
                               seed=TRAIN_SEED if split == "train" else TEST_SEED)


def partial_copy_baseline(cfg, test_data: str, device) -> dict:
    """CD and F1 of echoing the clamped partial scan as the prediction, batched and scored
    as :func:`pcdiff_torch.cli.evaluate.main` scores samples."""
    from ..data import BatchLoader, ModelNetCompletion
    from ..evals import CompletionMetrics

    dataset = ModelNetCompletion(test_data, split="test")
    label_to_class = {v: k for k, v in dataset.class_to_label.items()}
    loader = BatchLoader(dataset, cfg.sample.num_samples, shuffle=False,
                         seed=cfg.train.seed, drop_last=False)
    metrics = CompletionMetrics(fps_points=1024, device=device)
    for batch in loader:
        metrics.update(np.clip(batch["partial_pcd"], -0.5, 0.5), batch["target"],
                       batch["class_labels"])
    dataset.close()
    return metrics.summary(class_names=label_to_class)


def save_untrained(cfg, directory: str, device) -> str:
    """A fresh initialisation of the configured model from a generator seeded
    ``UNTRAINED_SEED``, saved as a train state at step 0 in ``directory``."""
    import torch

    from ..cli.train import build_model, init_params
    from ..core.checkpoint import save_checkpoint
    from ..train import create_train_state

    gen = torch.Generator(device=device).manual_seed(UNTRAINED_SEED)
    model = init_params(build_model(cfg, device), cfg, gen)
    state = create_train_state(model, lr=1e-4, total_steps=1, device=device)
    shutil.rmtree(directory, ignore_errors=True)  # a stale tree would not restore
    save_checkpoint(directory, 0, state)
    return directory


def _evaluate(cfg, device, log_name: Optional[str] = None) -> tuple:
    """Run :func:`pcdiff_torch.cli.evaluate.main` in the working directory; rename its log
    to ``log_name`` (or remove it). Returns the summary and the wall."""
    from ..cli import evaluate

    before = set(glob.glob("evaluation_log_*.txt"))
    t0 = time.perf_counter()
    summary = evaluate.main(cfg, device=device)
    seconds = time.perf_counter() - t0
    for log in sorted(set(glob.glob("evaluation_log_*.txt")) - before, key=os.path.getmtime):
        if log_name:
            os.replace(log, log_name)
        else:
            os.remove(log)
    return summary, seconds


def _row(summary: dict) -> dict:
    return {"overall": summary["overall"], "per_class": summary["per_class"]}


def run(run_dir: Optional[str] = None, overrides: List[str] = (), work: Optional[str] = None,
        dest: Optional[str] = None, seeds=SAMPLING_SEEDS, instances=INSTANCES,
        device="cuda") -> dict:
    """Train (unless ``run_dir`` is given) and score as the module's docstring says; write
    the record to ``dest`` and return it."""
    from ..cli import train
    from ..core.config import apply_overrides, load_config
    from ..core.device import resolve_device
    from .quality import card

    dev = resolve_device(device)
    work = os.path.abspath(work or tempfile.mkdtemp(prefix="pcdiff_shapes_"))
    os.makedirs(work, exist_ok=True)
    dest = os.path.abspath(dest or os.path.join(work, "shapes_evidence.json"))
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    overrides = list(overrides)
    cfg = load_config(CONFIG, overrides)
    record = dict(card=card() if dev.type == "cuda" else "cpu", device=str(dev),
                  config="configs/synthetic_shapes.yaml", overrides=overrides,
                  fixtures=dict(train=dict(instances_per_class=instances[0], seed=TRAIN_SEED),
                                test=dict(instances_per_class=instances[1], seed=TEST_SEED)))
    test_data = make_fixture(work, "test", instances[1])
    if run_dir is None:
        train_data = make_fixture(work, "train", instances[0])
        t0 = time.perf_counter()
        out = train.main(apply_overrides(cfg, [f"data.h5_path={train_data}",
                                               f"train.output_dir={work}/runs"]), device=dev)
        steps = sum(e["steps"] for e in out["epochs"])
        run_dir = out["run_dir"]
        record.update(
            train_s=time.perf_counter() - t0, steps=steps, resumed_step=out["resumed_step"],
            global_step=out["global_step"],
            ms_per_step=1e3 * sum(e["step_seconds"] for e in out["epochs"]) / max(steps, 1),
            # the median epoch's, past the first (which builds the kernels)
            ms_per_step_median=1e3 * float(np.median(
                [e["step_seconds"] / e["steps"] for e in out["epochs"][1:] or out["epochs"]])),
            first_loss=out["epochs"][0]["loss"], last_loss=out["epochs"][-1]["loss"])
        del out
    record["run_dir"] = os.path.basename(os.path.normpath(run_dir))
    print(f"run_dir: {run_dir}", flush=True)

    ckpt = os.path.join(run_dir, "checkpoints")
    held_out = [f"data.h5_path={test_data}"]
    results, walls = {}, {}
    cwd = os.getcwd()
    os.chdir(os.path.dirname(dest))  # the evaluation logs go beside the record
    try:
        print("=== trained, held-out instances ===", flush=True)
        summary, walls["trained_heldout"] = _evaluate(
            apply_overrides(cfg, held_out + [f"sample.load_checkpoint_path={ckpt}"]), dev,
            "evaluation_log_shapes.txt")
        results["trained_heldout"] = _row(summary)

        print("=== untrained (fresh init), held-out instances ===", flush=True)
        fresh = save_untrained(cfg, os.path.join(work, "fresh"), dev)
        summary, walls["untrained"] = _evaluate(
            apply_overrides(cfg, held_out + [f"sample.load_checkpoint_path={fresh}"]), dev,
            "evaluation_log_shapes_untrained.txt")
        results["untrained"] = _row(summary)

        print("=== copy-the-partial baseline ===", flush=True)
        t0 = time.perf_counter()
        results["partial_copy"] = _row(partial_copy_baseline(
            apply_overrides(cfg, held_out), test_data, dev))
        walls["partial_copy"] = time.perf_counter() - t0

        sampled = {str(cfg.train.seed): results["trained_heldout"]}
        for seed in seeds:
            print(f"=== trained, held-out instances, sampling seed {seed} ===", flush=True)
            summary, walls[f"seed {seed}"] = _evaluate(apply_overrides(cfg, held_out + [
                f"sample.load_checkpoint_path={ckpt}", f"train.seed={seed}"]), dev)
            sampled[str(seed)] = _row(summary)
        results["sampling_seeds"] = sampled
    finally:
        os.chdir(cwd)
    record["evaluate_s"] = walls
    results["run"] = record
    with open(dest, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"wrote {dest}")
    for k in ("trained_heldout", "untrained", "partial_copy"):
        o = results[k]["overall"]
        print(f"{k}: cd_full={o['cd_full']:.6f} f1_full={o['f1_full']:.6f}")
    return results


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("args", nargs="*",
                        help="[run_dir|-] then key.path=value overrides")
    parser.add_argument("--work", default=None)
    parser.add_argument("--dest", default=None)
    parser.add_argument("--seeds", default=",".join(map(str, SAMPLING_SEEDS)),
                        help="extra sampling seeds of the trained row (comma-separated)")
    parser.add_argument("--instances", default=",".join(map(str, INSTANCES)),
                        help="train,test instances a class")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, for the plain PyTorch versions")
    args = parser.parse_intermixed_args(argv)
    run_dir = args.args[0] if args.args and "=" not in args.args[0] else None
    overrides = args.args[1:] if run_dir is not None else args.args
    return run(None if run_dir == "-" else run_dir, overrides, work=args.work,
               dest=args.dest, seeds=[int(s) for s in args.seeds.split(",") if s],
               instances=tuple(int(s) for s in args.instances.split(",")),
               device=args.device)


if __name__ == "__main__":
    main()
