"""ModelNet-derived completion dataset.

The port's own copy of :mod:`pcdiff.data.modelnet` (numpy): the same samples, labels,
viewpoint table, skip lists and per-item normalisation (partial clamped to +-0.5, depth /
255, ground truth * 0.01 clamped to +-0.5 and randomly permuted; depth maps NHWC).

Storage: the path's suffix picks the format, and the two hold one schema.

- ``.h5``: the reference's H5 file, read through h5py (imported when such a file is
  opened; without h5py opening one raises an ImportError naming :func:`h5_to_npz`);
- ``.npz``: an uncompressed ``np.savez`` archive whose members are named by the H5
  dataset paths (``airplane/airplane_0000/partials/scan_0003/pointcloud``, ...), read
  by numpy alone. Groups are walked in sorted name order, as h5py walks them.

:func:`h5_to_npz` converts an H5 file to the archive (where h5py is installed), and
:func:`write_dataset` writes a ``{path: array}`` dict in either format.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Set

import numpy as np

__all__ = [
    "ModelNetCompletion",
    "DEFAULT_SKIP_CLASSES",
    "TRAIN_SKIP_INSTANCES",
    "build_viewpoint_table",
    "export_instance_ground_truths",
    "h5_to_npz",
    "write_dataset",
    "open_dataset",
]

DEFAULT_SKIP_CLASSES = ("dresser", "table", "desk", "bed", "chair")

# corrupt instances found by the reference's QA pass over its H5 file (train split only)
TRAIN_SKIP_INSTANCES: Set[str] = {
    "car/car_0239", "car/car_0241",
    "chair/chair_0940",
    "desk/desk_0241",
    "dresser/dresser_0243", "dresser/dresser_0244", "dresser/dresser_0251",
    "guitar/guitar_0158", "guitar/guitar_0191", "guitar/guitar_0194",
    "guitar/guitar_0205", "guitar/guitar_0216",
    "airplane/airplane_0087", "airplane/airplane_0103",
    "airplane/airplane_0152", "airplane/airplane_0207",
    "airplane/airplane_0378", "airplane/airplane_0433",
    "airplane/airplane_0449", "airplane/airplane_0477",
    "airplane/airplane_0485", "airplane/airplane_0512",
}


def _import_h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is an H5 file and h5py is not installed: convert it where h5py is, "
            "with pcdiff_torch.data.modelnet.h5_to_npz(src, dst), and pass the .npz") from e
    return h5py


def _suffix(path: str) -> str:
    for suffix in (".npz", ".h5", ".hdf5"):
        if str(path).endswith(suffix):
            return suffix
    raise ValueError(f"{path}: the dataset's suffix must be .npz or .h5")


class _NpzStore:
    """An ``np.savez`` archive seen as the H5 file's groups and datasets."""

    def __init__(self, path: str):
        self._npz = np.load(path)
        self._tree: Dict = {}
        for name in self._npz.files:
            node = self._tree
            for part in name.split("/"):
                node = node.setdefault(part, {})

    def keys(self, group: str = "") -> List[str]:
        node = self._tree
        for part in filter(None, group.split("/")):
            node = node[part]
        return sorted(node)

    def read(self, name: str) -> np.ndarray:
        return self._npz[name]

    def close(self) -> None:
        self._npz.close()


class _H5Store:
    def __init__(self, path: str):
        self._f = _import_h5py(path).File(path, "r")

    def keys(self, group: str = "") -> List[str]:
        return list((self._f[group] if group else self._f).keys())

    def read(self, name: str) -> np.ndarray:
        return self._f[name][()]

    def close(self) -> None:
        self._f.close()


def open_dataset(path: str):
    """The dataset file at ``path`` (``.npz`` or ``.h5``): ``keys(group)`` lists a
    group's members in the order h5py gives them, ``read(name)`` reads a dataset."""
    return _NpzStore(path) if _suffix(path) == ".npz" else _H5Store(path)


def write_dataset(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write ``{dataset path: array}`` to ``path`` in the format its suffix names."""
    if _suffix(path) == ".npz":
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return path
    h5py = _import_h5py(path)
    with h5py.File(path, "w") as f:
        for name, arr in arrays.items():
            f.create_dataset(name, data=arr)
    return path


def h5_to_npz(src: str, dst: str) -> str:
    """Convert the H5 file ``src`` to the uncompressed archive ``dst`` (needs h5py)."""
    h5py = _import_h5py(src)
    arrays: Dict[str, np.ndarray] = {}
    with h5py.File(src, "r") as f:
        f.visititems(lambda name, obj: arrays.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return write_dataset(dst, arrays)


def build_viewpoint_table() -> np.ndarray:
    """The scan-index -> camera-position table, axis-swapped to (x, z, y).

    scan_0000..0025: azimuth ring, (cos(15 deg * i), sin(15 deg * i), 0.25).
    scan_0026..0035: elevation arc on the unit xz-circle, x stepping 1 -> -1 by 2/9,
    values rounded to 6 decimals as the reference's constants are.
    """
    rows = []
    for i in range(26):
        a = math.radians(15.0 * i)
        rows.append((math.cos(a), math.sin(a), 0.25))
    # the reference's constants, quirks kept: |x| = 0.555556 rows carry z = 0.831211 (off
    # the unit circle), and |x| = 0.111111 rows are truncated (0.993807), not rounded
    z_quirks = {0.555556: 0.831211, 0.111111: 0.993807}
    for i in range(10):
        x = round(1.0 - 2.0 * i / 9.0, 6)
        z = z_quirks.get(abs(x))
        if z is None:
            z = 0.0 if abs(x) == 1.0 else round(math.sqrt(1.0 - x * x), 6)
        rows.append((x, 0.0, z))
    table = np.asarray(rows, dtype=np.float32)
    return table[:, [0, 2, 1]]


class ModelNetCompletion:
    """Map-style dataset over (instance, scan) pairs of a completion file (``.npz`` or
    ``.h5``)."""

    def __init__(
        self,
        h5_path: str,
        split: str = "train",
        skip_classes: Optional[Sequence[str]] = DEFAULT_SKIP_CLASSES,
        keep_h5_open: bool = True,
    ):
        assert split in ("train", "test")
        self.h5_path = h5_path
        self.split = split
        self.skip_instances = TRAIN_SKIP_INSTANCES if split == "train" else set()
        self.viewpoints = build_viewpoint_table()
        store = open_dataset(h5_path)
        self._store = store if keep_h5_open else None

        self.samples: List[Dict] = []
        try:
            classes = store.keys()
            if skip_classes is not None:
                names = sorted(n for n in classes if n not in skip_classes)
            else:
                names = list(classes)
            self.class_to_label = {cls: i for i, cls in enumerate(names)}

            for class_name in classes:
                if skip_classes and class_name in skip_classes:
                    continue
                for instance_id in store.keys(class_name):
                    if f"{class_name}/{instance_id}" in self.skip_instances:
                        continue
                    base = f"{class_name}/{instance_id}"
                    for scan_name in store.keys(f"{base}/partials"):
                        self.samples.append(dict(
                            class_name=class_name,
                            partial=f"{base}/partials/{scan_name}/pointcloud",
                            depth=f"{base}/partials/{scan_name}/distance",
                            target=f"{base}/ground_truth",
                            viewpoint_idx=int(scan_name.split("_")[-1]),
                        ))
        finally:
            if self._store is None:
                store.close()

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        s = self.samples[idx]
        store = self._store or open_dataset(self.h5_path)
        try:
            partial = np.asarray(store.read(s["partial"]), dtype=np.float32)
            depth = np.asarray(store.read(s["depth"]), dtype=np.float32)
            target = np.asarray(store.read(s["target"]), dtype=np.float32)
        finally:
            if self._store is None:
                store.close()

        partial = np.clip(partial, -0.5, 0.5)
        depth = depth / 255.0
        target = np.clip(target * 0.01, -0.5, 0.5)
        target = target[rng.permutation(target.shape[0])]

        return dict(
            class_labels=np.int32(self.class_to_label[s["class_name"]]),
            partial_pcd=partial,
            depth_maps=depth[..., None],  # NHWC
            viewpoints=self.viewpoints[s["viewpoint_idx"]],
            target=target,
        )

    def close(self):
        if self._store is not None:
            self._store.close()
            self._store = None


def export_instance_ground_truths(
    h5_path: str,
    skip_classes: Sequence[str] = DEFAULT_SKIP_CLASSES,
    npz_output: str = "modelnet_filtered_instances.npz",
    labels_output: str = "modelnet_filtered_labels.npz",
) -> Dict[str, np.ndarray]:
    """One normalised ground-truth cloud per kept instance (the reference batch for
    P-FID/P-IS): classes outside ``skip_classes`` relabelled 0..K-1 in sorted order,
    ground truth * 0.01 clamped to +-0.5, point order untouched; saved as two npz
    files."""
    all_gt: List[np.ndarray] = []
    all_labels: List[int] = []
    store = open_dataset(h5_path)
    try:
        classes = store.keys()
        names = sorted(n for n in classes if n not in skip_classes)
        class_to_label = {cls: i for i, cls in enumerate(names)}
        for class_name in classes:
            if class_name in skip_classes:
                continue
            for instance_id in store.keys(class_name):
                gt = np.asarray(store.read(f"{class_name}/{instance_id}/ground_truth"),
                                dtype=np.float32)
                all_gt.append(np.clip(gt * 0.01, -0.5, 0.5))
                all_labels.append(class_to_label[class_name])
    finally:
        store.close()

    ground_truths = np.stack(all_gt)
    labels = np.asarray(all_labels, dtype=np.int64)
    np.savez_compressed(npz_output, ground_truths=ground_truths)
    np.savez_compressed(labels_output, labels=labels)
    return {"ground_truths": ground_truths, "labels": labels}
