"""Quantitative evaluation: CD and F1 over the test split, overall and per class.

Counterpart of :mod:`pcdiff.cli.evaluate`: samples every scan of the test split (the last
batch may be ragged), clamps the predictions to +-0.5, and reports the squared-L2 chamfer
distance and F1@0.03 (and their FPS-to-1024 variants for larger samples) overall and
per class, to the console and to ``evaluation_log_<time>.txt`` in the working directory.
Returns the summary.

Usage: ``python -m pcdiff_torch.cli.evaluate [--config cfg.yaml] [--device cuda|cpu]
[key.path=value ...]``
"""

from __future__ import annotations

import datetime
import json
import logging
import time

import torch

from ..core.config import Config, load_config
from ..core.device import resolve_device
from ..data import BatchLoader, ModelNetCompletion
from ..evals import CompletionMetrics
from ..models.attention import fuse_ln_mlp_enabled
from ..models.wrapper import BoundTwoStream
from ..ops import attention_backend, layernorm_backend, lndense_backend
from ..ops.flash_attention import attention_softmax_dtype
from .sample import batch_kwargs, build_sampler, load_params
from .train import build_model, parse_args

logger = logging.getLogger("pcdiff_torch.evaluate")


def backends() -> str:
    """The port's kernel switches, as one line."""
    return (f"attention={attention_backend()} softmax={attention_softmax_dtype()} "
            f"lndense={lndense_backend()} layernorm={layernorm_backend()} "
            f"ln_mlp_fusion={'on' if fuse_ln_mlp_enabled() else 'off'}")


def main(cfg: Config, device="cuda") -> dict:
    dev = resolve_device(device)
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    # a file and stream logger of this module's own, not the root logger's
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    for handler in logger.handlers:
        handler.close()  # main() may run repeatedly in one process
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in (logging.StreamHandler(),
                    logging.FileHandler(f"evaluation_log_{timestamp}.txt")):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    model = build_model(cfg, dev)  # sets the config's kernel switches first
    logger.info(
        "evaluate: checkpoint=%s data=%s points=%d karras_steps=%d guidance=%.2f batch=%d "
        "device=%s backends: %s", cfg.sample.load_checkpoint_path, cfg.data.h5_path,
        cfg.model.num_points, cfg.sample.karras_steps, cfg.sample.guidance_scale,
        cfg.sample.num_samples, dev, backends())
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    load_params(cfg, model)
    sampler = build_sampler(cfg, BoundTwoStream(model.eval()))

    dataset = ModelNetCompletion(cfg.data.h5_path, split="test")
    label_to_class = {v: k for k, v in dataset.class_to_label.items()}
    loader = BatchLoader(dataset, cfg.sample.num_samples, shuffle=False,
                         seed=cfg.train.seed, drop_last=False)
    metrics = CompletionMetrics(fps_points=1024, device=dev)
    clouds, seconds = 0, 0.0
    for bi, batch in enumerate(loader):
        t0 = time.perf_counter()
        n = len(batch["target"])
        samples = sampler.sample_batch(n, batch_kwargs(batch, dev), gen)
        pred = samples.float().clamp(-0.5, 0.5)
        metrics.update(pred, batch["target"], batch["class_labels"])
        seconds += time.perf_counter() - t0
        clouds += n
        logger.info("evaluated batch %d (%d samples)", bi, n)
    dataset.close()

    summary = metrics.summary(class_names=label_to_class)
    logger.info("overall: %s", json.dumps(summary["overall"], indent=2))
    for cls, vals in summary["per_class"].items():
        logger.info("%s: cd_full=%.6f f1_full=%.6f", cls, vals["cd_full"], vals["f1_full"])
    summary["sampling"] = dict(clouds=clouds, seconds=seconds,
                               clouds_per_s=clouds / seconds if seconds else 0.0)
    logger.info("sampled and scored %d clouds in %.3f s (%.4f clouds/s)", clouds, seconds,
                summary["sampling"]["clouds_per_s"])
    return summary


def cli(argv=None):
    args = parse_args(argv, __doc__)
    main(load_config(args.config, args.overrides), device=args.device)


if __name__ == "__main__":
    cli()
