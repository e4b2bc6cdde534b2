"""ShapeNet-derived multimodal completion dataset.

The port's own copy of :mod:`pcdiff.data.multimodal` (numpy): the layout
``obj_type/obj_id/{points, depth_maps, viewpoints, target_points}`` with 154 scans an
object and the object's class in the group attribute ``label``; 40 scans an object chosen
by ``linspace``; the skip list; the fixed normalisation constants (depth [0, 255],
viewpoint max-abs 2.87765), recomputed over the kept scans where any is ``None``; depth
returned as ``[H, W, 1]``; the target permuted by the caller's numpy ``rng``. Groups are
walked in sorted name order, as h5py walks them. The file is ``.npz`` (the attribute as
the member ``obj_type/obj_id/@label``) or ``.h5``; see :mod:`pcdiff_torch.data.modelnet`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .modelnet import open_dataset

__all__ = ["MultiModalCompletion", "SHAPENET_LABEL_DICT", "DEFAULT_SKIP"]

SHAPENET_LABEL_DICT = {
    "airplane": 1, "cabinet": 2, "car": 3, "chair": 4, "lamp": 5, "sofa": 6,
    "table": 7, "watercraft": 8, "bed": 9, "bench": 10, "bookshelf": 11,
    "bus": 12, "guitar": 13, "motorbike": 14, "pistol": 15, "skateboard": 16,
}

DEFAULT_SKIP = (("car", "car_974"), ("car", "car_975"), ("car", "car_976"))


class MultiModalCompletion:
    """Map-style dataset over (object, scan) pairs of the multimodal file."""

    def __init__(self, h5_path: str, num_scans: int = 154, scans_per_object: int = 40,
                 depth_min: Optional[float] = 0.0, depth_max: Optional[float] = 255.0,
                 viewpoints_max_abs: Optional[float] = 2.87765, skip_list=DEFAULT_SKIP,
                 keep_h5_open: bool = True):
        self.h5_path = h5_path
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.viewpoints_max_abs = viewpoints_max_abs
        self.skip_list = set(tuple(x) for x in skip_list)
        store = open_dataset(h5_path)
        self._store = store if keep_h5_open else None

        self.index: List[Tuple[str, str, int]] = []
        try:
            for obj_type in store.keys():
                for obj_id in store.keys(obj_type):
                    if (obj_type, obj_id) in self.skip_list:
                        continue
                    for i in np.linspace(0, num_scans - 1, scans_per_object, dtype=int):
                        self.index.append((obj_type, obj_id, int(i)))
        finally:
            if self._store is None:
                store.close()

        if self.depth_min is None or self.depth_max is None or self.viewpoints_max_abs is None:
            self._compute_normalization_stats()

    def _open(self):
        return self._store or open_dataset(self.h5_path)

    def _compute_normalization_stats(self) -> None:
        depth_min, depth_max = float("inf"), float("-inf")
        vmax = float("-inf")
        store = self._open()
        try:
            for obj_type, obj_id, scan_idx in self.index:
                obj = f"{obj_type}/{obj_id}"
                depth = store.read(f"{obj}/depth_maps", scan_idx)
                view = store.read(f"{obj}/viewpoints", scan_idx)
                depth_min = min(depth_min, float(depth.min()))
                depth_max = max(depth_max, float(depth.max()))
                vmax = max(vmax, float(np.abs(view).max()))
        finally:
            if self._store is None:
                store.close()
        self.depth_min, self.depth_max, self.viewpoints_max_abs = depth_min, depth_max, vmax

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        obj_type, obj_id, scan_idx = self.index[idx]
        obj = f"{obj_type}/{obj_id}"
        store = self._open()
        try:
            partial = np.asarray(store.read(f"{obj}/points", scan_idx), dtype=np.float32)
            depth = np.asarray(store.read(f"{obj}/depth_maps", scan_idx), dtype=np.float32)
            view = np.asarray(store.read(f"{obj}/viewpoints", scan_idx), dtype=np.float32)
            target = np.asarray(store.read(f"{obj}/target_points"), dtype=np.float32)
            label_name = store.attr(obj, "label")
        finally:
            if self._store is None:
                store.close()

        depth = (depth - self.depth_min) / (self.depth_max - self.depth_min)
        view = view / self.viewpoints_max_abs
        target = target[rng.permutation(target.shape[0])]
        return dict(class_labels=np.int32(SHAPENET_LABEL_DICT[label_name]),
                    partial_pcd=partial, depth_maps=depth[..., None], viewpoints=view,
                    target=target)

    def close(self):
        if self._store is not None:
            self._store.close()
            self._store = None
