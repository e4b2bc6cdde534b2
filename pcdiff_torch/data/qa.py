"""Integrity audit of a ModelNet-completion file.

The port's own copy of :mod:`pcdiff.data.qa` (numpy), over ``.h5`` and ``.npz`` alike
(:func:`~pcdiff_torch.data.modelnet.open_dataset`): per class the value ranges of the
ground truths and partials and the moments of the ground truths, the scan count of each
instance, and the instances or scans with a missing member or a wrong point count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .modelnet import open_dataset

__all__ = ["audit_modelnet_h5", "H5AuditReport"]


@dataclass
class H5AuditReport:
    value_ranges: Dict[str, Dict[str, Tuple[float, float]]] = field(default_factory=dict)
    moments: Dict[str, Dict[str, Tuple[float, float]]] = field(default_factory=dict)
    scan_counts: Dict[str, List[int]] = field(default_factory=dict)
    incomplete_instances: List[str] = field(default_factory=list)
    bad_shapes: List[str] = field(default_factory=list)

    def ok(self) -> bool:
        return not self.incomplete_instances and not self.bad_shapes


def audit_modelnet_h5(h5_path: str, expected_points: Optional[int] = None,
                      expected_scans: Optional[int] = None,
                      max_instances_per_class: Optional[int] = None) -> H5AuditReport:
    """Audit a ModelNet-completion file (``.h5`` or ``.npz``) for the defects the
    reference's skip lists work around."""
    report = H5AuditReport()
    store = open_dataset(h5_path)
    try:
        for cls in store.keys():
            gmin, gmax = np.inf, -np.inf
            pmin, pmax = np.inf, -np.inf
            means, variances = [], []
            counts = []
            for i, inst in enumerate(store.keys(cls)):
                if max_instances_per_class and i >= max_instances_per_class:
                    break
                key = f"{cls}/{inst}"
                members = store.keys(key)
                if "ground_truth" not in members or "partials" not in members:
                    report.incomplete_instances.append(key)
                    continue
                gt = store.read(f"{key}/ground_truth")
                if expected_points and gt.shape[0] != expected_points:
                    report.bad_shapes.append(f"{key}/ground_truth{gt.shape}")
                gmin, gmax = min(gmin, float(gt.min())), max(gmax, float(gt.max()))
                means.append(float(gt.mean()))
                variances.append(float(gt.var()))
                scans = store.keys(f"{key}/partials")
                counts.append(len(scans))
                if expected_scans and len(scans) != expected_scans:
                    report.incomplete_instances.append(key)
                for s in scans:
                    scan = f"{key}/partials/{s}"
                    if not {"pointcloud", "distance"} <= set(store.keys(scan)):
                        report.incomplete_instances.append(f"{key}/{s}")
                        continue
                    pc = store.read(f"{scan}/pointcloud")
                    if expected_points and pc.shape[0] != expected_points:
                        report.bad_shapes.append(f"{key}/{s}{pc.shape}")
                    pmin = min(pmin, float(pc.min()))
                    pmax = max(pmax, float(pc.max()))
            report.value_ranges[cls] = {"ground_truth": (gmin, gmax), "partials": (pmin, pmax)}
            if means:
                report.moments[cls] = {
                    "mean": (float(np.mean(means)), float(np.std(means))),
                    "var": (float(np.mean(variances)), float(np.std(variances))),
                }
            report.scan_counts[cls] = counts
    finally:
        store.close()
    return report
