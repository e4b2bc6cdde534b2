"""What the Point-E entry points share: loading a model from a reference checkpoint, the
two-stage sampler of the examples, and timing its stages."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..core.point_e_import import import_point_e_torch_state
from ..diffusion import DIFFUSION_CONFIGS, PointCloudSampler, diffusion_from_config
from ..models.configs import MODEL_CONFIGS, model_from_config

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KARRAS_STEPS = (64, 64)  # the examples' steps: base, then the upsampler


def load_point_e(name: str, path: str, dtype: torch.dtype, device: torch.device):
    """The preset ``name`` with the weights of the reference checkpoint at ``path``."""
    model = model_from_config(MODEL_CONFIGS[name], dtype=dtype, device=device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(import_point_e_torch_state(sd), strict=True)
    return model.eval()


def two_stage_sampler(base, upsampler, base_name: str, upsample_embeddings: bool):
    """The examples' sampler: ``base_name`` then the upsampler, Karras 64 + 64 steps,
    sigma_max [120, 160], s_churn [3, 0], guidance [3, 0], RGB aux channels; the upsampler
    sees the grid embeddings only with ``upsample_embeddings`` (the text example's does
    not, so it conditions on a zero grid)."""

    def base_fn(x, t, embeddings=None, **_):
        return base(x, t, embeddings=embeddings)

    def up_fn(x, t, low_res=None, embeddings=None, **_):
        return upsampler(x, t, low_res=low_res,
                         embeddings=embeddings if upsample_embeddings else None)

    return PointCloudSampler(
        models=[base_fn, up_fn],
        diffusions=[diffusion_from_config(DIFFUSION_CONFIGS[base_name]),
                    diffusion_from_config(DIFFUSION_CONFIGS["upsample"])],
        num_points=[1024, 4096 - 1024],
        aux_channels=["R", "G", "B"],
        guidance_scale=[3.0, 0.0],
        model_kwargs_key_filter=["*", "*"] if upsample_embeddings else ["embeddings", ""],
        use_karras=[True, True], karras_steps=list(KARRAS_STEPS),
        sigma_min=[1e-3, 1e-3], sigma_max=[120, 160], s_churn=[3, 0],
    )


def timed(fn, device: torch.device):
    """(fn(), wall seconds, card ms or None off the card)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def sample_stages(sampler: PointCloudSampler, batch_size: int, model_kwargs: Dict,
                  generator: torch.Generator, device: torch.device):
    """The sampler's final samples and, for each stage, its wall seconds, card ms and
    clouds a second."""
    stages: List[Dict] = []
    it = sampler.sample_batch_progressive(batch_size, model_kwargs, generator)
    samples = None
    for _ in range(sampler.num_stages):
        samples, wall, card = timed(lambda: next(it), device)
        stages.append({"seconds": wall, "card_ms": card, "clouds_per_s": batch_size / wall})
    return samples, stages
