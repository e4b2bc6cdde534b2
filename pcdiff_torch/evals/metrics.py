"""Completion metrics: CD and F1, overall and per class.

Counterpart of :mod:`pcdiff.evals.metrics`: per batch, the full-resolution squared-L2
chamfer distance, F1 at 0.03 and F1 at a squared threshold of 1e-4, and, for samples of
more than ``fps_points`` points, CD and F1 of their deterministic FPS subset; sums per
class, and per-class and overall means.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.fps import fps
from ..geometry.ops import chamfer_distance_xyz, fscore, fscore_squared

__all__ = ["CompletionMetrics", "batch_cd_f1"]


@torch.no_grad()
def batch_cd_f1(pred: torch.Tensor, gt: torch.Tensor):
    """Per-sample (cd, f1, f1_squared) [B] for [B, N, 3] clouds: F1 at the Euclidean
    threshold 0.03, f1_squared at the squared threshold 1e-4."""
    cd = chamfer_distance_xyz(pred, gt)
    f1, _, _ = fscore(pred, gt, threshold=0.03)
    f1_sq, _, _ = fscore_squared(pred, gt, threshold=1e-4)
    return cd, f1, f1_sq


def _numpy(*tensors):
    return [t.double().cpu().numpy() for t in tensors]


class CompletionMetrics:
    """Accumulate CD/F1 per class over evaluation batches, on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, fps_points: Optional[int] = 1024, device="cuda"):
        from ..core.device import resolve_device

        self.fps_points = fps_points
        self.device = resolve_device(device)
        # cd, f1, f1_squared, cd_fps, f1_fps, n
        self._sums = defaultdict(lambda: np.zeros(6))

    def update(self, pred, gt, class_labels) -> None:
        """pred/gt: [B, N, 3] arrays or tensors (pred clamped to +-0.5 by the caller)."""
        pred = torch.as_tensor(pred, device=self.device)
        gt = torch.as_tensor(gt, device=self.device)
        cd, f1, f1_sq = _numpy(*batch_cd_f1(pred, gt))
        if self.fps_points is not None and pred.shape[1] > self.fps_points:
            pred_fps = fps(pred, self.fps_points, deterministic=True)
            cd_fps, f1_fps, _ = _numpy(*batch_cd_f1(pred_fps, gt))
        else:
            cd_fps, f1_fps = cd, f1
        for i, label in enumerate(np.asarray(torch.as_tensor(class_labels).cpu())):
            self._sums[int(label)] += [cd[i], f1[i], f1_sq[i], cd_fps[i], f1_fps[i], 1.0]

    def summary(self, class_names: Optional[Dict[int, str]] = None) -> Dict:
        def row(sums):
            n = sums[5]
            return dict(
                cd_full=sums[0] / n, f1_full=sums[1] / n,
                f1_squared_full=sums[2] / n,
                cd_fps=sums[3] / n, f1_fps=sums[4] / n, count=int(n),
            )

        per_class = {}
        total = np.zeros(6)
        for label, sums in sorted(self._sums.items()):
            total += sums
            name = class_names.get(label, str(label)) if class_names else str(label)
            per_class[name] = row(sums)
        total[5] = max(total[5], 1.0)
        return dict(overall=row(total), per_class=per_class)
