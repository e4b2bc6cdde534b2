"""Point cloud -> mesh with the SDF model: the cloud encoded once, the SDF evaluated over a
``grid_size ** 3`` lattice in chunks of queries on the card, the zero level set extracted
by marching cubes on the host, vertex colours from the nearest cloud points.

Counterpart of ``examples/pointcloud2mesh.py``, with its arguments, plus ``--batch-size``
(queries a chunk), ``--dtype`` and ``--device`` (default ``cuda``)::

    python -m pcdiff_torch.examples.pointcloud2mesh --pointcloud cloud.npz \\
        --sdf-checkpoint sdf.pt --grid-size 128
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core import resolve_device
from ..core.point_e_import import import_sdf_torch_state
from ..geometry.point_cloud import PointCloud
from ..models.configs import MODEL_CONFIGS, model_from_config
from ..utils.pc_to_mesh import mesh_from_volume, sdf_volume
from ._common import DTYPES, timed


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pointcloud", required=True, help=".npz PointCloud")
    p.add_argument("--sdf-checkpoint", required=True)
    p.add_argument("--grid-size", type=int, default=128)
    p.add_argument("--output", default="mesh.ply")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default=None)
    return p


def main(argv=None, device="cuda") -> dict:
    """Returns the mesh, the SDF volume, the card time of the encoding and lattice
    prediction and the host time of the extraction."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device or device)
    model = model_from_config(MODEL_CONFIGS["sdf"], dtype=DTYPES[args.dtype], device=dev)
    model.load_state_dict(import_sdf_torch_state(
        torch.load(args.sdf_checkpoint, map_location="cpu", weights_only=True)), strict=True)
    pc = PointCloud.load(args.pointcloud)
    volume, predict_s, predict_ms = timed(
        lambda: sdf_volume(pc, model, batch_size=args.batch_size, grid_size=args.grid_size),
        dev)
    t0 = time.perf_counter()
    mesh = mesh_from_volume(volume, pc, fill_vertex_channels=True)
    march_s = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        mesh.write_ply(f)
    print(f"wrote {args.output} ({len(mesh.verts)} verts, {len(mesh.faces)} faces)")
    return {"mesh": mesh, "volume": volume, "predict_s": predict_s, "predict_ms": predict_ms,
            "march_s": march_s}


if __name__ == "__main__":
    main()
