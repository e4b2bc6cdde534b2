"""MVP completion benchmark dataset.

The port's own copy of :mod:`pcdiff.data.mvp` (numpy): ``MVP_{Train,Test}_CP`` with
2048-point incomplete scans, complete ground truths and 16-class labels (1-16); 26 scans an
instance, so ``complete = gt[index // 26]``; the test prefix has no ground truth. Below
2048 points the whole array is FPS-downsampled to ``n_samples`` up front and cached as
float16: by the native host FPS (``native/fps.cpp``) with the JAX package's starts, element
b at index b % 256, so the indices are the JAX package's exactly; without a host compiler by
the port's own FPS (:mod:`pcdiff_torch.geometry.fps`) on the CPU in chunks of 256, as the
JAX package falls back to its device FPS. Each fetch permutes the ground truth by the
caller's numpy ``rng``. The file is ``.npz`` or ``.h5``
(:func:`~pcdiff_torch.data.modelnet.open_dataset`).

The labels run 1-16: a model built with ``model.num_classes`` <= 16 (``configs/modelnet.yaml``
has 10) gets NaN class tokens for the labels past its table, as the JAX package's
``nn.Embed`` does; train MVP with ``model.num_classes=17``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .modelnet import open_dataset

__all__ = ["MVPCompletion", "MVP_LABEL_DICT", "SCANS_PER_INSTANCE"]

MVP_LABEL_DICT = {
    "airplane": 1, "cabinet": 2, "car": 3, "chair": 4, "lamp": 5, "sofa": 6,
    "table": 7, "watercraft": 8, "bed": 9, "bench": 10, "bookshelf": 11,
    "bus": 12, "guitar": 13, "motorbike": 14, "pistol": 15, "skateboard": 16,
}

SCANS_PER_INSTANCE = 26
FPS_CHUNK = 256


def fps_downsample(points: np.ndarray, n: int, batch: int = FPS_CHUNK) -> np.ndarray:
    """FPS the whole [M, N, 3] array to [M, n, 3]: the native host FPS where it builds,
    else the port's FPS in chunks of ``batch``; element b starts at index b % ``batch``
    either way."""
    from ..geometry.fps import fps
    from ..geometry.fps_native import native_fps_indices

    starts = np.arange(len(points), dtype=np.int32) % batch
    idx = native_fps_indices(points, n, starts=starts)
    if idx is not None:
        return np.take_along_axis(points, idx[..., None].astype(np.int64), axis=1)
    out = [fps(torch.from_numpy(np.ascontiguousarray(points[i:i + batch])), n,
               deterministic=True).numpy() for i in range(0, len(points), batch)]
    return np.concatenate(out, axis=0)


class MVPCompletion:
    """Map-style dataset over MVP incomplete/complete pairs."""

    def __init__(self, h5_path: str, prefix: str = "train", n_samples: Optional[int] = None,
                 limit: Optional[int] = None):
        if prefix not in ("train", "val", "test"):
            raise ValueError("prefix should be [train/val/test]")
        self.prefix = prefix
        self.n_samples = 2048 if n_samples is None else n_samples

        store = open_dataset(h5_path)
        try:
            self.input_data = np.asarray(store.read("incomplete_pcds"))
            if limit:
                self.input_data = self.input_data[:limit]
            if prefix != "test":
                self.gt_data = np.asarray(store.read("complete_pcds"))
                self.labels = np.asarray(store.read("labels"))
        finally:
            store.close()

        if self.n_samples < 2048:
            if prefix != "test":
                self.gt_data = fps_downsample(self.gt_data, self.n_samples).astype(np.float16)
            self.input_data = fps_downsample(self.input_data, self.n_samples).astype(
                np.float16)

    def __len__(self) -> int:
        return self.input_data.shape[0]

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        partial = np.asarray(self.input_data[index], dtype=np.float32)
        if self.prefix == "test":
            return dict(partial_pcd=partial)
        complete = np.asarray(self.gt_data[index // SCANS_PER_INSTANCE], dtype=np.float32)
        complete = complete[rng.permutation(complete.shape[0])]
        return dict(class_labels=np.int32(self.labels[index]), partial_pcd=partial,
                    target=complete)
