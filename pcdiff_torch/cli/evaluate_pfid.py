"""P-FID between two npz sample batches.

Counterpart of :mod:`pcdiff.cli.evaluate_pfid`: streams each batch's ``arr_0`` (a glob
of shards, with an optional ``[:N]`` slice) through the PointNet++ extractor in chunks
of its batch size, fits a Gaussian to each side's features and prints their Frechet
distance as the last line, ``P-FID: <value>``.

Usage: ``python -m pcdiff_torch.cli.evaluate_pfid batch1.npz batch2.npz --checkpoint
pointnet.pt [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from ..evals.feature_extractor import PointNetClassifier
from ..evals.fid_is import compute_statistics
from ..evals.npz_stream import NpzStreamer


def read_clouds(glob_path: str, batch_size: int, clf: PointNetClassifier) -> np.ndarray:
    """The features of every cloud of ``glob_path``'s ``arr_0``, read ``batch_size`` at a
    time."""
    feats = []
    for batch in NpzStreamer(glob_path).stream(batch_size, ["arr_0"]):
        f, _ = clf.features_and_preds(batch["arr_0"])
        feats.append(f)
    return np.concatenate(feats, axis=0)


def main(argv=None, device="cuda") -> float:
    """Print and return the P-FID of the two batches that ``argv`` names, with the
    extractor on ``device`` (``--device`` overrides it)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("batch_1")
    parser.add_argument("batch_2")
    parser.add_argument("--checkpoint", required=True,
                        help="pretrained pointnet .pt checkpoint")
    parser.add_argument("--cache_dir", default=None,
                        help="accepted as the JAX package's CLI accepts it; unused")
    parser.add_argument("--device", default=device,
                        help="cuda (the default) or cpu, for the plain PyTorch versions")
    args = parser.parse_args(argv)

    clf = PointNetClassifier(torch_checkpoint_path=args.checkpoint, device=args.device)
    print("computing first batch activations")
    feats_1 = read_clouds(args.batch_1, clf.batch_size, clf)
    print("computing second batch activations")
    feats_2 = read_clouds(args.batch_2, clf.batch_size, clf)
    stats_1, stats_2 = compute_statistics(feats_1), compute_statistics(feats_2)
    pfid = stats_1.frechet_distance(stats_2)
    print(f"P-FID: {pfid}")
    return pfid


if __name__ == "__main__":
    main()
