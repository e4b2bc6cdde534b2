"""Point cloud -> mesh: the SDF on a lattice, then its zero level set.

Counterpart of :mod:`pcdiff.utils.pc_to_mesh`: encode the cloud once, evaluate the SDF on a
``grid_size ** 3`` lattice over a centred cube of ``side_length`` in fixed-size chunks of
queries (the last one padded, as the JAX package pads its jitted chunks), centre a volume
of one sign, extract the zero level set with :func:`pcdiff_torch.utils.marching.marching_cubes`
(or ``marching_tetrahedra``) and fill vertex channels from each vertex's nearest cloud point.
:func:`sdf_volume` runs on the model's device (the lattice is made there, and the volume
comes back to the host once); :func:`mesh_from_volume` runs on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..geometry.mesh import TriMesh
from ..geometry.point_cloud import PointCloud
from .marching import marching_cubes, marching_tetrahedra

__all__ = ["marching_cubes_mesh", "sdf_volume", "mesh_from_volume"]


@torch.no_grad()
def sdf_volume(pc: PointCloud, model, *, batch_size: int = 4096, grid_size: int = 128,
               side_length: float = 1.02) -> np.ndarray:
    """The SDF of ``pc`` on the lattice, ``[grid_size] * 3`` fp32 on the host (x slowest).
    ``model`` is the port's SDF model
    (:class:`pcdiff_torch.models.sdf.CrossAttentionPointCloudSDFModel`) or any module with
    its ``encode_point_clouds(clouds [1, N, 3])`` and ``predict_sdf(queries [1, M, 3],
    encoded) -> [1, M]``; the lattice is made on its parameters' device (the CPU for a
    module without parameters)."""
    device = next(model.parameters(), torch.empty(0)).device
    voxel = side_length / (grid_size - 1)
    lo = -side_length / 2
    coords = torch.as_tensor(np.asarray(pc.coords, dtype=np.float32), device=device)[None]
    encoded = model.encode_point_clouds(coords)
    total = grid_size ** 3
    vols = []
    for i in range(0, total, batch_size):
        idx = torch.arange(i, i + batch_size, dtype=torch.int64, device=device)
        # the coordinates in fp64, rounded once to fp32, as the JAX package makes them
        zs = (idx % grid_size).double() * voxel + lo
        ys = ((idx // grid_size) % grid_size).double() * voxel + lo
        xs = (idx // grid_size ** 2).double() * voxel + lo
        q = torch.stack([xs, ys, zs], dim=-1).to(torch.float32)
        q[idx >= total] = 0.0  # the padded tail
        vols.append(model.predict_sdf(q[None], encoded)[0, : min(batch_size, total - i)]
                    .float())
    return torch.cat(vols).reshape(grid_size, grid_size, grid_size).cpu().numpy()


def mesh_from_volume(volume: np.ndarray, pc: PointCloud, *, side_length: float = 1.02,
                     fill_vertex_channels: bool = True, method: str = "cubes") -> TriMesh:
    """The zero level set of an SDF ``volume`` over the centred cube of ``side_length`` (a
    volume of one sign is centred first), with vertex channels from ``pc``."""
    grid_size = volume.shape[0]
    voxel = side_length / (grid_size - 1)
    lo = -side_length / 2
    if np.all(volume < 0) or np.all(volume > 0):
        volume = volume - np.mean(volume)
    if method == "cubes":
        verts, faces, normals = marching_cubes(volume, level=0.0, spacing=(voxel,) * 3)
        verts = verts + lo
    elif method == "tetrahedra":
        verts, faces = marching_tetrahedra(volume, level=0.0)
        verts = verts * voxel + lo
        normals = _face_normals(verts, faces)
    else:
        raise ValueError(f"unknown method: {method}")
    return TriMesh(verts=verts, faces=faces, normals=normals,
                   vertex_channels=(_nearest_vertex_channels(pc, verts)
                                    if fill_vertex_channels else {}))


def marching_cubes_mesh(pc: PointCloud, model, *, batch_size: int = 4096, grid_size: int = 128,
                        side_length: float = 1.02, fill_vertex_channels: bool = True,
                        method: str = "cubes") -> TriMesh:
    """The SDF zero surface of a point cloud as a triangle mesh (:func:`sdf_volume`, then
    :func:`mesh_from_volume`)."""
    volume = sdf_volume(pc, model, batch_size=batch_size, grid_size=grid_size,
                        side_length=side_length)
    return mesh_from_volume(volume, pc, side_length=side_length,
                            fill_vertex_channels=fill_vertex_channels, method=method)


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    if len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.where(norm < 1e-12, 1.0, norm)).astype(np.float32)


def _nearest_vertex_channels(pc: PointCloud, verts: np.ndarray) -> Dict[str, np.ndarray]:
    if not pc.channels or len(verts) == 0:
        return {}
    nearest = pc.nearest_points(verts)
    return {ch: arr[nearest] for ch, arr in pc.channels.items()}
