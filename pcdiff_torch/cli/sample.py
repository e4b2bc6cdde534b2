"""Batch sampling to PLY or NPZ files.

Counterpart of :mod:`pcdiff.cli.sample`: loads the weights (a port checkpoint of either
kind, i.e. a full train state or a bare EMA shadow, or a reference ``.pt``), samples one
fixed subset of the test split (the first ``sample.num_samples`` scans) conditioned on
its partial scans, and saves its targets, partials and samples under
``sample.output_dir/batch_0000``.

Usage: ``python -m pcdiff_torch.cli.sample [--config cfg.yaml] [--device cuda|cpu]
[key.path=value ...]``
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np
import torch

from ..core.checkpoint import load_weights
from ..core.config import Config, load_config
from ..core.device import resolve_device
from ..data import BatchLoader, ModelNetCompletion
from ..diffusion.sampler import PointCloudSampler
from ..geometry import PointCloud
from ..models.wrapper import BoundTwoStream
from .train import build_diffusion, build_model, parse_args

logger = logging.getLogger("pcdiff_torch.sample")

_COND_KEYS = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")


def load_params(cfg: Config, model) -> Dict[str, torch.Tensor]:
    """Load ``sample.load_checkpoint_path`` into ``model`` and return the weights."""
    path = cfg.sample.load_checkpoint_path
    if not path:
        raise FileNotFoundError("sample.load_checkpoint_path is not set")
    weights = load_weights(path)
    model.load_state_dict(weights)
    return weights


def build_sampler(cfg: Config, bound: BoundTwoStream) -> PointCloudSampler:
    """The configured one-stage sampler over ``bound``: any solver of
    ``sample.sampler`` (``heun_parallel`` with ``sample.parallel_window`` and
    ``sample.parallel_tol``), or the DDPM ancestral chain when ``sample.use_karras`` is
    false."""
    s = cfg.sample
    return PointCloudSampler(
        models=[bound], diffusions=[build_diffusion(cfg)],
        num_points=[cfg.model.num_points], aux_channels=[],
        guidance_scale=[s.guidance_scale], clip_denoised=True,
        use_karras=[s.use_karras], karras_steps=[s.karras_steps],
        sigma_min=[s.sigma_min], sigma_max=[s.sigma_max], s_churn=[s.s_churn],
        sampler=s.sampler,
        parallel_options=dict(window=s.parallel_window, tol=s.parallel_tol),
        guidance_interval=((s.guidance_interval_lo, s.guidance_interval_hi)
                           if s.guidance_interval_hi > s.guidance_interval_lo else None),
    )


def save_cloud_batch(points: np.ndarray, out_dir: str, prefix: str,
                     fmt: str = "ply") -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i, pts in enumerate(points):
        pc = PointCloud(coords=np.asarray(pts))
        path = os.path.join(out_dir, f"{prefix}_{i + 1}.{fmt}")
        if fmt == "ply":
            with open(path, "wb") as f:
                pc.write_ply(f)
        else:
            pc.save(path)


def batch_kwargs(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's conditioning inputs on ``device``: those it has (MVP has no view and
    no depth map)."""
    return {k: torch.as_tensor(batch[k], device=device) for k in _COND_KEYS if k in batch}


def main(cfg: Config, device="cuda") -> Dict[str, object]:
    """Sample the fixed test subset on ``device``. Returns the batch's directory
    (``dir``) and the ``targets``, ``partials`` and ``samples`` written there."""
    dev = resolve_device(device)
    logging.basicConfig(level=logging.INFO)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    model = build_model(cfg, dev)
    load_params(cfg, model)
    sampler = build_sampler(cfg, BoundTwoStream(model.eval()))

    dataset = ModelNetCompletion(cfg.data.h5_path, split="test")
    loader = BatchLoader(dataset, cfg.sample.num_samples, shuffle=False,
                         seed=cfg.train.seed, prefetch=0)
    out_dir, fmt = cfg.sample.output_dir, cfg.sample.save_format
    batch = next(iter(loader))  # one fixed subset, as the reference's single pass
    samples = sampler.sample_batch(len(batch["target"]), batch_kwargs(batch, dev), gen)
    base = os.path.join(out_dir, "batch_0000")
    save_cloud_batch(batch["target"], os.path.join(base, "targets"), "target", fmt)
    save_cloud_batch(batch["partial_pcd"], os.path.join(base, "partials"), "partial", fmt)
    samples = samples.float().cpu().numpy()
    save_cloud_batch(samples, os.path.join(base, "samples"), "sample", fmt)
    logger.info("saved batch 0 (%d samples) to %s", len(batch["target"]), base)
    dataset.close()
    return dict(dir=base, targets=batch["target"], partials=batch["partial_pcd"],
                samples=samples)


def cli(argv=None):
    args = parse_args(argv, __doc__)
    main(load_config(args.config, args.overrides), device=args.device)


if __name__ == "__main__":
    cli()
