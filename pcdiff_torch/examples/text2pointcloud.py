"""Text -> point cloud with the Point-E stack: the CLIP ViT-L/14 text embedding conditions
base40M-textvec, then the upsampler (on a zero grid) adds 3072 points.

Counterpart of ``examples/text2pointcloud.py``, with its arguments (``--tokens``: an
``.npy`` of token ids ``[1, 77]``; else ``--prompt`` through CLIP's tokenizer, which needs
the merges file ``--bpe``), plus ``--batch-size``, ``--dtype`` and ``--device`` (default
``cuda``)::

    python -m pcdiff_torch.examples.text2pointcloud --prompt "a red motorcycle" \\
        --bpe bpe_simple_vocab_16e6.txt.gz --base-checkpoint base_40m_textvec.pt \\
        --upsample-checkpoint upsample_40m.pt --clip-checkpoint ViT-L-14.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import resolve_device
from ..models.clip import ImageCLIP, import_clip_torch_state
from ._common import DTYPES, load_point_e, sample_stages, timed, two_stage_sampler


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompt", default="a red motorcycle")
    p.add_argument("--base-checkpoint", required=True,
                   help="base40M-textvec .pt checkpoint path")
    p.add_argument("--upsample-checkpoint", required=True)
    p.add_argument("--clip-checkpoint", required=True,
                   help="OpenAI CLIP ViT-L/14 state_dict path")
    p.add_argument("--tokens", default=None, help="npy file of prompt token ids [1, 77]")
    p.add_argument("--bpe", default=None, help="CLIP's BPE merges file, for --prompt")
    p.add_argument("--output", default="text2pc.ply")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default=None)
    return p


def main(argv=None, device="cuda") -> dict:
    """Returns the samples ``[B, 4096, 6]``, the clouds, and the timings of the text
    embedding and of each sampler stage."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device or device)
    dtype = DTYPES[args.dtype]
    base = load_point_e("base40M-textvec", args.base_checkpoint, dtype, dev)
    upsampler = load_point_e("upsample", args.upsample_checkpoint, dtype, dev)
    clip = ImageCLIP(import_clip_torch_state(
        torch.load(args.clip_checkpoint, map_location="cpu", weights_only=True)),
        bpe_path=args.bpe, dtype=dtype, device=dev)

    tokens = np.load(args.tokens) if args.tokens else clip._tokenize([args.prompt])
    emb, clip_s, clip_ms = timed(lambda: clip.embed_text(np.asarray(tokens)), dev)
    emb = emb.expand(args.batch_size, -1).contiguous()

    sampler = two_stage_sampler(base, upsampler, "base40M-textvec", upsample_embeddings=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    samples, stages = sample_stages(sampler, args.batch_size, {"embeddings": emb}, gen, dev)
    clouds = sampler.output_to_point_clouds(samples)
    with open(args.output, "wb") as f:
        clouds[0].write_ply(f)
    print(f"wrote {args.output} ({len(clouds[0])} points)")
    return {"samples": samples, "clouds": clouds, "stages": stages,
            "clip": {"seconds": clip_s, "card_ms": clip_ms}}


if __name__ == "__main__":
    main()
