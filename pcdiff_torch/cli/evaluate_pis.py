"""P-IS (inception score) of an npz sample batch.

Counterpart of :mod:`pcdiff.cli.evaluate_pis`: streams the batch's ``arr_0`` through the
PointNet++ extractor in chunks of its batch size and prints the inception score of the
class probabilities as the last line, ``P-IS: <value>``.

Usage: ``python -m pcdiff_torch.cli.evaluate_pis batch.npz --checkpoint pointnet.pt
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from ..evals.feature_extractor import PointNetClassifier
from ..evals.fid_is import compute_inception_score
from ..evals.npz_stream import NpzStreamer


def main(argv=None, device="cuda") -> float:
    """Print and return the P-IS of the batch that ``argv`` names, with the extractor on
    ``device`` (``--device`` overrides it)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("batch")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--device", default=device,
                        help="cuda (the default) or cpu, for the plain PyTorch versions")
    args = parser.parse_args(argv)

    clf = PointNetClassifier(torch_checkpoint_path=args.checkpoint, device=args.device)
    preds = []
    for batch in NpzStreamer(args.batch).stream(clf.batch_size, ["arr_0"]):
        _, p = clf.features_and_preds(batch["arr_0"])
        preds.append(p)
    pis = compute_inception_score(np.concatenate(preds, axis=0))
    print(f"P-IS: {pis}")
    return pis


if __name__ == "__main__":
    main()
