"""Image -> point cloud with the Point-E stack: the CLIP ViT-L/14 token grid conditions
base40M, then the upsampler (4096 coloured points).

Counterpart of ``examples/image2pointcloud.py``, with its arguments, plus ``--batch-size``
(clouds from one image), ``--dtype`` and ``--device`` (default ``cuda``). The
image is read with Pillow, or as a uint8 HWC ``.npy``. The checkpoints are the reference's
``state_dict`` files (base40M, upsample_40m, OpenAI's CLIP ViT-L/14)::

    python -m pcdiff_torch.examples.image2pointcloud --image corgi.jpg \\
        --base-checkpoint base_40m.pt --upsample-checkpoint upsample_40m.pt \\
        --clip-checkpoint ViT-L-14.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import resolve_device
from ..models.clip import ImageCLIP, import_clip_torch_state, preprocess_image
from ._common import DTYPES, load_point_e, sample_stages, timed, two_stage_sampler


def read_image(path: str) -> np.ndarray:
    """A uint8 HWC RGB image from an ``.npy`` file or, through Pillow, an image file."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", required=True, help="RGB image path (or a uint8 HWC .npy)")
    p.add_argument("--base-checkpoint", required=True)
    p.add_argument("--upsample-checkpoint", required=True)
    p.add_argument("--clip-checkpoint", required=True)
    p.add_argument("--output", default="image2pc.ply")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default=None)
    return p


def main(argv=None, device="cuda") -> dict:
    """Returns the samples ``[B, 4096, 6]``, the clouds, and the timings of the grid
    embedding and of each sampler stage."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device or device)
    dtype = DTYPES[args.dtype]
    base = load_point_e("base40M", args.base_checkpoint, dtype, dev)
    upsampler = load_point_e("upsample", args.upsample_checkpoint, dtype, dev)
    clip = ImageCLIP(import_clip_torch_state(
        torch.load(args.clip_checkpoint, map_location="cpu", weights_only=True)),
        dtype=dtype, device=dev)

    pixels = preprocess_image(read_image(args.image))[None]
    grid, clip_s, clip_ms = timed(lambda: clip.embed_images_grid(pixels), dev)
    grid = grid.expand(args.batch_size, -1, -1).contiguous()

    sampler = two_stage_sampler(base, upsampler, "base40M", upsample_embeddings=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    samples, stages = sample_stages(sampler, args.batch_size, {"embeddings": grid}, gen, dev)
    clouds = sampler.output_to_point_clouds(samples)
    with open(args.output, "wb") as f:
        clouds[0].write_ply(f)
    print(f"wrote {args.output} ({len(clouds[0])} points)")
    return {"samples": samples, "clouds": clouds, "stages": stages,
            "clip": {"seconds": clip_s, "card_ms": clip_ms}}


if __name__ == "__main__":
    main()
