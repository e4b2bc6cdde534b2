"""Triangle mesh container with npz and PLY IO.

The port's own copy of :mod:`pcdiff.geometry.mesh` (numpy), with the reference's
``TriMesh`` interface: vertex and face arrays, optional per-face normals, channels stored
under ``v_``/``f_`` keys in npz, and binary PLY export with optional vertex colours.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Optional, Union

import numpy as np

from .ply import write_ply

__all__ = ["TriMesh"]


@dataclass
class TriMesh:
    """A 3D triangle mesh with optional data at the vertices and faces."""

    verts: np.ndarray  # [N, 3] vertex coordinates
    faces: np.ndarray  # [M, 3] vertex indices per triangle
    normals: Optional[np.ndarray] = None  # [M, 3] per-face normals
    vertex_channels: Dict[str, np.ndarray] = field(default_factory=dict)
    face_channels: Dict[str, np.ndarray] = field(default_factory=dict)

    @classmethod
    def load(cls, f: Union[str, BinaryIO]) -> "TriMesh":
        """Load from .npz (channels stored under ``v_<name>`` / ``f_<name>``)."""
        if isinstance(f, str):
            with open(f, "rb") as reader:
                return cls.load(reader)
        obj = np.load(f)
        keys = list(obj.keys())
        return cls(
            verts=obj["verts"],
            faces=obj["faces"],
            normals=obj["normals"] if "normals" in keys else None,
            vertex_channels={k[2:]: obj[k] for k in keys if k.startswith("v_")},
            face_channels={k[2:]: obj[k] for k in keys if k.startswith("f_")},
        )

    def save(self, f: Union[str, BinaryIO]) -> None:
        if isinstance(f, str):
            with open(f, "wb") as writer:
                self.save(writer)
            return
        obj = dict(verts=self.verts, faces=self.faces)
        if self.normals is not None:
            obj["normals"] = self.normals
        for k, v in self.vertex_channels.items():
            obj[f"v_{k}"] = v
        for k, v in self.face_channels.items():
            obj[f"f_{k}"] = v
        np.savez(f, **obj)

    def has_vertex_colors(self) -> bool:
        return all(c in self.vertex_channels for c in "RGB")

    def write_ply(self, raw_f: BinaryIO) -> None:
        rgb = None
        if self.has_vertex_colors():
            rgb = np.stack([self.vertex_channels[c] for c in "RGB"], axis=1)
        write_ply(raw_f, coords=self.verts, rgb=rgb, faces=self.faces)
