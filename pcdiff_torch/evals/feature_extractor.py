"""PointNet++ features and class probabilities for P-FID / P-IS.

Counterpart of :mod:`pcdiff.evals.feature_extractor`: each cloud is centred and scaled
to the unit sphere (numpy, in the extractor's dtype), then the width-2 PointNet++ runs
over fixed-size chunks, the last padded by repeating its last cloud, since FPS starts
depend on a cloud's position in its chunk; it returns the fc2 features and the
probabilities. ``dtype=np.float64`` runs the forward in fp64, the canonical mode for
comparing P-FID across implementations: fp32 products are reduction-order sensitive, and
the ill-conditioned Frechet square root amplifies that. With a ``mesh``, each rank of its
``data`` axis runs its equal share of every chunk's rows (FPS starting each cloud at its
index in the whole chunk, as one process does), and the features and probabilities are
put back together on every rank, as the JAX package shards each chunk over ``data``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..parallel.mesh import DATA_AXIS, axis_rank, gather_shares
from .pointnet2 import PointNet2ClassifierSSG, import_pointnet2_torch_state

__all__ = ["normalize_point_clouds", "PointNetClassifier"]

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def normalize_point_clouds(pc: np.ndarray) -> np.ndarray:
    """Centre each cloud and scale it to the unit sphere."""
    centroids = np.mean(pc, axis=1, keepdims=True)
    pc = pc - centroids
    m = np.max(np.sqrt(np.sum(pc**2, axis=-1, keepdims=True)), axis=1, keepdims=True)
    return pc / m


class PointNetClassifier:
    """A PointNet++ SSG classifier returning features and probabilities.

    Weights come from ``state_dict`` (the reference's layout, as
    :func:`~pcdiff_torch.evals.pointnet2.pointnet2_state_from_flax` also gives it) or from
    the torch checkpoint at ``torch_checkpoint_path`` (its ``model_state_dict`` if it has
    one). ``dtype`` is ``np.float32`` (the default) or ``np.float64``; the model runs on
    ``device``, the card unless the caller asks for the CPU. ``mesh`` shards each chunk's
    rows over its ``data`` axis; ``batch_size`` must divide over it."""

    def __init__(
        self,
        state_dict: Optional[Mapping] = None,
        torch_checkpoint_path: Optional[str] = None,
        batch_size: int = 64,
        width_mult: int = 2,
        num_class: int = 40,
        dtype=None,
        device="cuda",
        mesh=None,
    ):
        self.device = resolve_device(device)
        if state_dict is None:
            if torch_checkpoint_path is None:
                raise ValueError("pass state_dict or torch_checkpoint_path")
            state_dict = torch.load(torch_checkpoint_path, map_location="cpu",
                                    weights_only=True)
            if "model_state_dict" in state_dict:
                state_dict = state_dict["model_state_dict"]
        self.dtype = np.dtype(dtype) if dtype is not None else np.dtype(np.float32)
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")
        model = PointNet2ClassifierSSG(num_class=num_class, normal_channel=False,
                                       width_mult=width_mult)
        model.load_state_dict(import_pointnet2_torch_state(state_dict), strict=True)
        self.model = model.to(device=self.device, dtype=_TORCH_DTYPES[self.dtype]).eval()
        self.batch_size = batch_size
        self.mesh = mesh
        self._rank, self._ranks = axis_rank(mesh, DATA_AXIS)
        if batch_size % self._ranks:
            raise ValueError(f"batch_size {batch_size} must divide over the mesh's data "
                             f"axis ({self._ranks})")

    @torch.no_grad()
    def _forward(self, chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        per = len(chunk) // self._ranks
        rows = torch.from_numpy(chunk[self._rank * per:(self._rank + 1) * per])
        log_probs, _, feats = self.model(rows.to(self.device), features=True,
                                         row_offset=self._rank * per)
        probs = log_probs.exp()
        if self.mesh is not None:
            feats, probs = (gather_shares(t, self.mesh, DATA_AXIS, dim=0)
                            for t in (feats, probs))
        return feats.cpu().numpy(), probs.cpu().numpy()

    def features_and_preds(self, point_clouds: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """point_clouds [N, P, 3] -> (features [N, F], probabilities [N, C])."""
        pc = normalize_point_clouds(np.asarray(point_clouds, dtype=self.dtype))
        feats_out, preds_out = [], []
        for i in range(0, len(pc), self.batch_size):
            chunk = pc[i : i + self.batch_size]
            keep = len(chunk)
            if keep < self.batch_size:
                chunk = np.concatenate(
                    [chunk, chunk[-1:].repeat(self.batch_size - keep, axis=0)])
            feats, preds = self._forward(np.ascontiguousarray(chunk))
            feats_out.append(feats[:keep])
            preds_out.append(preds[:keep])
        return np.concatenate(feats_out, axis=0), np.concatenate(preds_out, axis=0)
