"""Host-side point-cloud container with npz and PLY IO.

The port's own copy of :mod:`pcdiff.geometry.point_cloud` (numpy), with the reference's
``PointCloud`` interface: npz load and save, PLY export, random and farthest-point
subsets, channel selection, nearest points and concatenation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Union

import numpy as np

from .ply import write_ply

COLORS = frozenset(["R", "G", "B", "A"])


def preprocess(data: np.ndarray, channel: str) -> np.ndarray:
    """Color channels are stored in [0,1] and exported as rounded [0,255]."""
    if channel in COLORS:
        return np.round(data * 255.0)
    return data


@dataclass
class PointCloud:
    """Points sampled on a surface plus named per-point channel attributes.

    coords: [N, 3] float array; channels: name -> [N] array.
    """

    coords: np.ndarray
    channels: Dict[str, np.ndarray] = field(default_factory=dict)

    @classmethod
    def load(cls, f: Union[str, BinaryIO]) -> "PointCloud":
        """Load from an .npz file with a ``coords`` key plus channel keys."""
        if isinstance(f, str):
            with open(f, "rb") as reader:
                return cls.load(reader)
        obj = np.load(f)
        return cls(
            coords=obj["coords"],
            channels={k: obj[k] for k in obj.keys() if k != "coords"},
        )

    def save(self, f: Union[str, BinaryIO]) -> None:
        if isinstance(f, str):
            with open(f, "wb") as writer:
                self.save(writer)
            return
        np.savez(f, coords=self.coords, **self.channels)

    def write_ply(self, raw_f: BinaryIO) -> None:
        rgb = None
        if all(c in self.channels for c in "RGB"):
            rgb = np.stack([self.channels[c] for c in "RGB"], axis=1)
        write_ply(raw_f, coords=self.coords, rgb=rgb)

    def __len__(self) -> int:
        return len(self.coords)

    def random_sample(
        self,
        num_points: int,
        *,
        rng: Optional[np.random.Generator] = None,
        **subsample_kwargs,
    ) -> "PointCloud":
        """Uniform random subset of at most ``num_points`` points."""
        if len(self.coords) <= num_points:
            return self
        rng = rng or np.random.default_rng()
        indices = rng.choice(len(self.coords), size=(num_points,), replace=False)
        return self.subsample(indices, **subsample_kwargs)

    def farthest_point_sample(
        self,
        num_points: int,
        init_idx: Optional[int] = None,
        *,
        rng: Optional[np.random.Generator] = None,
        **subsample_kwargs,
    ) -> "PointCloud":
        """Greedy farthest-point subset (O(N*M) numpy; host-side sizes only)."""
        n = len(self.coords)
        if n <= num_points:
            return self
        rng = rng or np.random.default_rng()
        coords = self.coords.astype(np.float64)
        sq_norms = np.sum(coords**2, axis=-1)

        def dists_to(idx: int) -> np.ndarray:
            return sq_norms + sq_norms[idx] - 2.0 * (coords @ coords[idx])

        indices = np.zeros([num_points], dtype=np.int64)
        indices[0] = int(rng.integers(n)) if init_idx is None else init_idx
        cur = dists_to(indices[0])
        for i in range(1, num_points):
            idx = int(np.argmax(cur))
            indices[i] = idx
            cur = np.minimum(cur, dists_to(idx))
        return self.subsample(indices, **subsample_kwargs)

    def subsample(self, indices: np.ndarray, average_neighbors: bool = False) -> "PointCloud":
        """Take points at ``indices``; optionally average channel values of
        each dropped point into its nearest kept point."""
        if not average_neighbors:
            return PointCloud(
                coords=self.coords[indices],
                channels={k: v[indices] for k, v in self.channels.items()},
            )
        new_coords = self.coords[indices]
        neighbor = PointCloud(coords=new_coords).nearest_points(self.coords)
        neighbor[indices] = np.arange(len(indices))
        new_channels = {}
        for k, v in self.channels.items():
            v_sum = np.zeros_like(v[: len(indices)])
            v_count = np.zeros_like(v[: len(indices)])
            np.add.at(v_sum, neighbor, v)
            np.add.at(v_count, neighbor, 1)
            new_channels[k] = v_sum / v_count
        return PointCloud(coords=new_coords, channels=new_channels)

    def select_channels(self, channel_names: List[str]) -> np.ndarray:
        return np.stack(
            [preprocess(self.channels[name], name) for name in channel_names], axis=-1
        )

    def nearest_points(self, points: np.ndarray, batch_size: int = 16384) -> np.ndarray:
        """Index into self.coords of the nearest own point, for each query point."""
        norms = np.sum(self.coords**2, axis=-1)
        out = []
        for i in range(0, len(points), batch_size):
            batch = points[i : i + batch_size]
            d = norms + np.sum(batch**2, axis=-1)[:, None] - 2 * (batch @ self.coords.T)
            out.append(np.argmin(d, axis=-1))
        return np.concatenate(out, axis=0)

    def combine(self, other: "PointCloud") -> "PointCloud":
        assert self.channels.keys() == other.channels.keys()
        return PointCloud(
            coords=np.concatenate([self.coords, other.coords], axis=0),
            channels={
                k: np.concatenate([v, other.channels[k]], axis=0)
                for k, v in self.channels.items()
            },
        )
