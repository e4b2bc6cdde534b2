"""Offline FPS downsampling of completion H5 datasets.

Counterpart of :mod:`pcdiff.cli.downsample`: walks a full-resolution ModelNet-completion
H5 file, takes each ground truth and partial scan down to ``n`` points by deterministic
farthest point sampling and writes ``out.h5`` in the same layout. Instances with fewer
than ``--min-points`` points are skipped, as are scans with fewer than ``n`` and the
classes of ``--skip-classes``. FPS runs as the JAX package's tool runs it: the native
library (:mod:`pcdiff_torch.geometry.fps_native`) where the host can build it, otherwise
:mod:`pcdiff_torch.geometry.fps` on ``--device``; the log says which. h5py is imported
only when the files are opened.

Usage: ``python -m pcdiff_torch.cli.downsample in.h5 out.h5 --n 1024 [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..core.device import resolve_device
from ..geometry.fps import fps
from ..geometry.fps_native import native_available, native_fps_indices

logger = logging.getLogger("pcdiff_torch.downsample")


def fps_batch(points_list, n: int, device="cuda") -> np.ndarray:
    """The clouds of ``points_list`` (each [N, C], one N) taken down to ``n`` points each
    by deterministic FPS -> [B, n, C]: by the native library where the host can build it,
    otherwise on ``device``."""
    stacked_np = np.stack(points_list)
    idx = native_fps_indices(stacked_np, n)
    if idx is not None:
        logger.debug("fps_batch: native FPS on the host")
        return np.take_along_axis(stacked_np, idx[..., None], axis=1)
    dev = resolve_device(device)
    logger.debug("fps_batch: pcdiff_torch.geometry.fps on %s", dev)
    return fps(torch.from_numpy(stacked_np).to(dev), n, deterministic=True).cpu().numpy()


def main(argv=None, device="cuda") -> None:
    """Downsample the H5 file that ``argv`` names; without the native library FPS runs on
    ``device`` (``--device`` overrides it)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_h5")
    parser.add_argument("output_h5")
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--min-points", type=int, default=4096)
    parser.add_argument("--skip-classes", nargs="*", default=["guitar"])
    parser.add_argument("--batch", type=int, default=64,
                        help="accepted as the JAX package's tool accepts it; unused")
    parser.add_argument("--device", default=device,
                        help="where FPS runs without the native library: cuda (the "
                             "default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    route = ("the native library (native/fps.cpp)" if native_available()
             else f"pcdiff_torch.geometry.fps on {resolve_device(args.device)}")
    logger.info("downsample: FPS to %d points by %s", args.n, route)

    import h5py

    with h5py.File(args.input_h5, "r") as fin, h5py.File(args.output_h5, "w") as fout:
        for cls in fin.keys():
            if cls in args.skip_classes:
                print(f"skipping class {cls}")
                continue
            gcls = fout.create_group(cls)
            for inst in fin[cls].keys():
                grp = fin[cls][inst]
                gt = grp["ground_truth"][()]
                if gt.shape[0] < args.min_points:
                    print(f"skipping {cls}/{inst}: only {gt.shape[0]} points")
                    continue
                ginst = gcls.create_group(inst)
                ginst.create_dataset(
                    "ground_truth", data=fps_batch([gt], args.n, args.device)[0])
                gpart = ginst.create_group("partials")
                for s in grp["partials"].keys():
                    sg = grp["partials"][s]
                    pc = sg["pointcloud"][()]
                    if pc.shape[0] < args.n:
                        print(f"skipping scan {cls}/{inst}/{s}: {pc.shape[0]} pts")
                        continue
                    sgo = gpart.create_group(s)
                    sgo.create_dataset("pointcloud",
                                       data=fps_batch([pc], args.n, args.device)[0])
                    sgo.create_dataset("distance", data=sg["distance"][()])
            print(f"done class {cls}")


if __name__ == "__main__":
    main()
