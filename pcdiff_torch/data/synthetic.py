"""Synthetic data: in-memory batches, and fixtures in the ModelNet-completion schema.

The port's own copy of :mod:`pcdiff.data.synthetic` (numpy; the same draws from the same
seed): ``synthetic_batch``, the uniform-random fixture ``make_modelnet_fixture`` and the
parametric-shapes fixture ``make_shapes_fixture`` in the ModelNet-completion layout
(``class/instance/{ground_truth, partials/scan_XXXX/{pointcloud, distance}}``), and the
uniform-random ``make_mvp_fixture`` (``incomplete_pcds``, ``complete_pcds``, ``labels``)
and ``make_multimodal_fixture`` (``obj_type/obj_id/{points, depth_maps, viewpoints,
target_points}`` with the group attribute ``label``). Each is written in the format its
path's suffix names: ``.npz`` (numpy alone) or ``.h5`` (h5py); see
:mod:`pcdiff_torch.data.modelnet`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["synthetic_batch", "make_modelnet_fixture", "make_shapes_fixture",
           "make_mvp_fixture", "make_multimodal_fixture", "SYNTHETIC_CLASSES"]

SYNTHETIC_CLASSES = ("airplane", "bench", "bottle", "car", "monitor")


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    num_points: int = 1024,
    num_partial: int = 1024,
    depth_size: int = 512,
    num_classes: int = 10,
) -> Dict[str, np.ndarray]:
    """A random batch shaped like the ModelNet loader's output (channels-last; depth maps
    NHWC)."""
    return dict(
        target=rng.uniform(-0.5, 0.5, (batch_size, num_points, 3)).astype(np.float32),
        class_labels=rng.integers(0, num_classes, (batch_size,)).astype(np.int32),
        partial_pcd=rng.uniform(-0.5, 0.5, (batch_size, num_partial, 3)).astype(
            np.float32),
        depth_maps=rng.random((batch_size, depth_size, depth_size, 1)).astype(np.float32),
        viewpoints=rng.standard_normal((batch_size, 3)).astype(np.float32),
    )


def make_modelnet_fixture(
    path: str,
    classes: Sequence[str] = SYNTHETIC_CLASSES,
    instances_per_class: int = 2,
    scans_per_instance: int = 3,
    num_points: int = 64,
    depth_size: int = 64,
    seed: int = 0,
) -> str:
    """Write a small uniform-random fixture with the ModelNet-completion layout to
    ``path`` (``.npz`` or ``.h5``)."""
    from .modelnet import write_dataset

    rng = np.random.default_rng(seed)
    arrays: Dict[str, np.ndarray] = {}
    for cls in classes:
        for i in range(instances_per_class):
            inst = f"{cls}/{cls}_{i:04d}"
            # stored ground truth is x100 (the loader multiplies by 0.01)
            arrays[f"{inst}/ground_truth"] = rng.uniform(
                -50, 50, (num_points, 3)).astype(np.float32)
            for s in range(scans_per_instance):
                scan = f"{inst}/partials/scan_{s:04d}"
                arrays[f"{scan}/pointcloud"] = rng.uniform(
                    -0.5, 0.5, (num_points, 3)).astype(np.float32)
                arrays[f"{scan}/distance"] = (
                    rng.random((depth_size, depth_size)) * 255).astype(np.float32)
    write_dataset(path, arrays)
    return path


def make_mvp_fixture(path: str, num_instances: int = 2, scans_per_instance: int = 26,
                     num_points: int = 2048, seed: int = 0) -> str:
    """Write a small uniform-random fixture with the MVP benchmark's layout (26 scans an
    instance, labels 1-16) to ``path`` (``.npz`` or ``.h5``)."""
    from .modelnet import write_dataset

    rng = np.random.default_rng(seed)
    n_scans = num_instances * scans_per_instance
    arrays = {
        "incomplete_pcds": rng.uniform(-0.5, 0.5, (n_scans, num_points, 3)).astype(
            np.float32),
        "complete_pcds": rng.uniform(-0.5, 0.5, (num_instances, num_points, 3)).astype(
            np.float32),
        "labels": rng.integers(1, 17, (n_scans,)).astype(np.int64),
    }
    return write_dataset(path, arrays)


def make_multimodal_fixture(path: str, num_objects: int = 2, num_scans: int = 8,
                            num_points: int = 64, depth_size: int = 32, seed: int = 0) -> str:
    """Write a small uniform-random fixture with the ShapeNet-multimodal layout (class
    ``car``, each object's class in its group attribute ``label``) to ``path`` (``.npz``
    or ``.h5``)."""
    from .modelnet import write_dataset

    rng = np.random.default_rng(seed)
    arrays: Dict[str, np.ndarray] = {}
    attrs: Dict[str, Dict[str, str]] = {}
    for i in range(num_objects):
        obj = f"car/car_{i}"
        attrs[obj] = {"label": "car"}
        arrays[f"{obj}/points"] = rng.uniform(
            -0.5, 0.5, (num_scans, num_points, 3)).astype(np.float32)
        arrays[f"{obj}/depth_maps"] = (
            rng.random((num_scans, depth_size, depth_size)) * 255).astype(np.float32)
        arrays[f"{obj}/viewpoints"] = rng.uniform(-2.8, 2.8, (num_scans, 3)).astype(
            np.float32)
        arrays[f"{obj}/target_points"] = rng.uniform(
            -0.5, 0.5, (num_points, 3)).astype(np.float32)
    return write_dataset(path, arrays, attrs)


# The shapes fixture: each class a parametric assembly of primitives with per-instance
# variation, partials view-dependent crops from the viewpoint table, depth maps z-buffer
# projections from that viewpoint. Train and test files from different seeds hold
# disjoint instances.


def _sample_ellipsoid(rng, n, center, radii):
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    return (v * radii + center).astype(np.float32)


def _sample_box(rng, n, center, half):
    # uniform over the 6 faces, weighted by face area
    hx, hy, hz = half
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    faces = rng.choice(6, size=n, p=areas / areas.sum())
    p = rng.uniform(-1.0, 1.0, (n, 3)) * half
    axis = faces // 2
    sign = np.where(faces % 2 == 0, 1.0, -1.0)
    p[np.arange(n), axis] = sign * np.asarray(half)[axis]
    return (p + center).astype(np.float32)


def _sample_cylinder(rng, n, center, radius, half_h, axis=2):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-half_h, half_h, n)
    p = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], axis=1)
    if axis != 2:
        p[:, [axis, 2]] = p[:, [2, axis]]
    return (p + center).astype(np.float32)


def _shape_cloud(cls: str, rng: np.random.Generator, n: int) -> np.ndarray:
    """Points on a class-specific primitive assembly with instance variation."""
    s = lambda lo=0.75, hi=1.25: rng.uniform(lo, hi)  # noqa: E731
    parts = []
    if cls == "airplane":
        parts = [
            (_sample_ellipsoid, dict(center=[0, 0, 0],
                                     radii=[0.40 * s(), 0.06 * s(), 0.06 * s()]), 0.4),
            (_sample_ellipsoid, dict(center=[0.05, 0, 0],
                                     radii=[0.08 * s(), 0.38 * s(), 0.015]), 0.4),
            (_sample_ellipsoid, dict(center=[-0.33, 0, 0.06],
                                     radii=[0.05 * s(), 0.14 * s(), 0.015]), 0.2),
        ]
    elif cls == "bench":
        seat_h = 0.05 * s()
        parts = [
            (_sample_box, dict(center=[0, 0, 0.05],
                               half=[0.35 * s(), 0.12 * s(), seat_h]), 0.5),
            (_sample_box, dict(center=[0.30, 0.09, -0.15],
                               half=[0.02, 0.02, 0.15]), 0.125),
            (_sample_box, dict(center=[-0.30, 0.09, -0.15],
                               half=[0.02, 0.02, 0.15]), 0.125),
            (_sample_box, dict(center=[0.30, -0.09, -0.15],
                               half=[0.02, 0.02, 0.15]), 0.125),
            (_sample_box, dict(center=[-0.30, -0.09, -0.15],
                               half=[0.02, 0.02, 0.15]), 0.125),
        ]
    elif cls == "bottle":
        body_r = 0.12 * s()
        parts = [
            (_sample_cylinder, dict(center=[0, 0, -0.08], radius=body_r,
                                    half_h=0.22 * s()), 0.6),
            (_sample_cylinder, dict(center=[0, 0, 0.22], radius=0.04 * s(),
                                    half_h=0.08 * s()), 0.25),
            (_sample_ellipsoid, dict(center=[0, 0, 0.32],
                                     radii=[0.05, 0.05, 0.03]), 0.15),
        ]
    elif cls == "car":
        parts = [
            (_sample_box, dict(center=[0, 0, -0.05],
                               half=[0.40 * s(), 0.16 * s(), 0.08 * s()]), 0.45),
            (_sample_box, dict(center=[-0.02, 0, 0.08],
                               half=[0.20 * s(), 0.14 * s(), 0.06 * s()]), 0.25),
            (_sample_ellipsoid, dict(center=[0.25, 0.16, -0.14],
                                     radii=[0.07, 0.03, 0.07]), 0.075),
            (_sample_ellipsoid, dict(center=[-0.25, 0.16, -0.14],
                                     radii=[0.07, 0.03, 0.07]), 0.075),
            (_sample_ellipsoid, dict(center=[0.25, -0.16, -0.14],
                                     radii=[0.07, 0.03, 0.07]), 0.075),
            (_sample_ellipsoid, dict(center=[-0.25, -0.16, -0.14],
                                     radii=[0.07, 0.03, 0.07]), 0.075),
        ]
    elif cls == "monitor":
        parts = [
            (_sample_box, dict(center=[0, 0, 0.10],
                               half=[0.30 * s(), 0.02, 0.20 * s()]), 0.6),
            (_sample_cylinder, dict(center=[0, 0, -0.16], radius=0.025,
                                    half_h=0.08 * s()), 0.15),
            (_sample_box, dict(center=[0, 0, -0.26],
                               half=[0.14 * s(), 0.10 * s(), 0.015]), 0.25),
        ]
    else:  # fallback: a lone ellipsoid
        parts = [
            (_sample_ellipsoid, dict(center=[0, 0, 0],
                                     radii=[0.3 * s(), 0.3 * s(), 0.3 * s()]), 1.0),
        ]
    counts = np.maximum(1, (np.array([w for _, _, w in parts]) * n).astype(int))
    counts[-1] += n - counts.sum()
    clouds = [fn(rng, int(c), **kw) for (fn, kw, _), c in zip(parts, counts)]
    cloud = np.concatenate(clouds, axis=0)[:n]
    return np.clip(cloud, -0.49, 0.49)


def _view_basis(view: np.ndarray):
    c = view / (np.linalg.norm(view) + 1e-9)
    up = np.array([0.0, 0.0, 1.0]) if abs(c[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(up, c)
    u /= np.linalg.norm(u) + 1e-9
    w = np.cross(c, u)
    return c, u, w


def _partial_and_depth(cloud, view, n_partial, depth_size, rng):
    """View-dependent crop + z-buffer depth image from camera position 2*view."""
    c, u, w = _view_basis(view)
    along = cloud @ c
    # keep the near-facing 60% of points (what a scanner would see, roughly)
    keep = along >= np.quantile(along, 0.4)
    pts = cloud[keep]
    if len(pts) == 0:
        pts = cloud
    idx = rng.choice(len(pts), size=n_partial, replace=len(pts) < n_partial)
    partial = pts[idx]

    px = np.clip(((cloud @ u + 0.6) / 1.2 * depth_size).astype(int), 0, depth_size - 1)
    py = np.clip(((cloud @ w + 0.6) / 1.2 * depth_size).astype(int), 0, depth_size - 1)
    dist = 2.0 - along  # camera sits at 2*c looking inward
    depth = np.full((depth_size, depth_size), dist.max(), dtype=np.float32)
    np.minimum.at(depth, (py, px), dist)
    lo, hi = depth.min(), depth.max()
    depth = (depth - lo) / (hi - lo + 1e-9) * 255.0
    return partial.astype(np.float32), depth


def make_shapes_fixture(
    path: str,
    classes: Sequence[str] = SYNTHETIC_CLASSES,
    instances_per_class: int = 8,
    scans_per_instance: int = 6,
    num_points: int = 256,
    depth_size: int = 64,
    seed: int = 0,
) -> str:
    """The parametric-shapes fixture in the ModelNet-completion schema, written to
    ``path`` (``.npz`` or ``.h5``). Different seeds draw disjoint instances: write the
    train and test files with different seeds for a held-out-instance split."""
    from .modelnet import build_viewpoint_table, write_dataset

    rng = np.random.default_rng(seed)
    views = build_viewpoint_table()
    arrays: Dict[str, np.ndarray] = {}
    for cls in classes:
        for i in range(instances_per_class):
            cloud = _shape_cloud(cls, rng, num_points)
            inst = f"{cls}/{cls}_{seed:02d}{i:02d}"
            arrays[f"{inst}/ground_truth"] = (cloud * 100.0).astype(np.float32)
            scan_ids = rng.choice(len(views), size=scans_per_instance, replace=False)
            for sid in sorted(scan_ids):
                partial, depth = _partial_and_depth(cloud, views[sid], num_points,
                                                    depth_size, rng)
                arrays[f"{inst}/partials/scan_{sid:04d}/pointcloud"] = partial
                arrays[f"{inst}/partials/scan_{sid:04d}/distance"] = depth
    write_dataset(path, arrays)
    return path
