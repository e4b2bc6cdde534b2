"""Vectorised isosurface extraction on the host (numpy): marching cubes and marching
tetrahedra.

The port's own copy of :mod:`pcdiff.utils.marching`, which the mesh path needs on a
machine without JAX; the two give equal arrays. :func:`marching_cubes` is a lookup-table
marching cubes: vertices are the linearly interpolated zero crossings on the 12 cube edges
(scikit-image's positions), faces come from a 256-entry configuration table generated at
import (for each corner-sign configuration, 2-D marching-squares segments on each cube face
are chained into boundary loops and fan-triangulated, oriented inside to outside), so
adjacent cubes agree and the mesh is watertight. Faces follow the right-hand rule outwards,
the reference's convention after its winding fix; ``gradient_direction`` follows
scikit-image's vertex-normal convention (default ``descent``). :func:`marching_tetrahedra`
(six tetrahedra a cube) needs no table and gives the same surface, more densely
triangulated.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["marching_cubes", "marching_tetrahedra"]


# --------------------------------------------------------------------------
# Marching cubes
# --------------------------------------------------------------------------

# corner c at offset (x, y, z); bottom face 0-3 (z=0), top face 4-7 (z=1)
_MC_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)
# the 12 cube edges as (corner, corner)
_MC_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]
# the 6 faces as cyclic corner quads
_MC_FACES = [
    (0, 1, 2, 3), (4, 5, 6, 7),
    (0, 1, 5, 4), (3, 2, 6, 7),
    (0, 3, 7, 4), (1, 2, 6, 5),
]
# local edge id -> (axis family 0=x/1=y/2=z, grid offset within the cube)
_MC_EDGE_GRID = [
    (0, (0, 0, 0)), (1, (1, 0, 0)), (0, (0, 1, 0)), (1, (0, 0, 0)),
    (0, (0, 0, 1)), (1, (1, 0, 1)), (0, (0, 1, 1)), (1, (0, 0, 1)),
    (2, (0, 0, 0)), (2, (1, 0, 0)), (2, (1, 1, 0)), (2, (0, 1, 0)),
]

_EDGE_OF_PAIR = {frozenset(e): i for i, e in enumerate(_MC_EDGES)}


def _face_segments(face, inside):
    """Marching-squares segments on one face: pairs of cube-edge ids.

    The ambiguous (diagonal) case always separates the inside corners — a
    deterministic rule over the face state alone, so the two cubes sharing a
    face produce identical boundaries.
    """
    quad = list(face)
    edges = [
        _EDGE_OF_PAIR[frozenset((quad[i], quad[(i + 1) % 4]))] for i in range(4)
    ]
    bits = [inside[c] for c in quad]
    n = sum(bits)
    if n in (0, 4):
        return []
    if n in (1, 3):
        # cut off the lone corner (inside if n==1, outside if n==3)
        i = bits.index(True) if n == 1 else bits.index(False)
        return [(edges[(i - 1) % 4], edges[i])]
    if bits[0] == bits[2]:
        # diagonal pair: cut off each INSIDE corner (separates them)
        return [
            (edges[(i - 1) % 4], edges[i]) for i in range(4) if bits[i]
        ]
    # adjacent pair: one segment through the two sign-change edges
    crossing = [edges[i] for i in range(4) if bits[i] != bits[(i + 1) % 4]]
    return [(crossing[0], crossing[1])]


def _build_mc_table() -> Tuple[np.ndarray, int]:
    """[256, max_entries] int8 table of edge-id triples (pad -1)."""
    mids = np.array(
        [(_MC_CORNERS[a] + _MC_CORNERS[b]) / 2.0 for a, b in _MC_EDGES]
    )
    rows = []
    for config in range(256):
        inside = [(config >> c) & 1 == 1 for c in range(8)]
        # incidence: crossing edge -> its two neighbor crossing edges
        segs = []
        for face in _MC_FACES:
            segs.extend(_face_segments(face, inside))
        adj = {}
        for a, b in segs:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        assert all(len(v) == 2 for v in adj.values()), (config, adj)
        # chain into loops
        seen = set()
        entries = []
        for start in sorted(adj):
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            prev, cur = start, adj[start][0]
            while cur != start:
                loop.append(cur)
                seen.add(cur)
                nxt = adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
                prev, cur = cur, nxt
            # orient: right-hand normal points from inside toward outside
            pts = mids[loop]
            normal = np.zeros(3)
            for i in range(1, len(loop) - 1):
                normal += np.cross(pts[i] - pts[0], pts[i + 1] - pts[0])
            ins_pts, out_pts = [], []
            for e in loop:
                a, b = _MC_EDGES[e]
                ins, out = (a, b) if inside[a] else (b, a)
                ins_pts.append(_MC_CORNERS[ins])
                out_pts.append(_MC_CORNERS[out])
            d = np.mean(out_pts, axis=0) - np.mean(ins_pts, axis=0)
            if np.dot(normal, d) < 0:
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                entries.extend((loop[0], loop[i], loop[i + 1]))
        rows.append(entries)
    width = max(len(r) for r in rows)
    table = np.full((256, width), -1, dtype=np.int8)
    for i, r in enumerate(rows):
        table[i, : len(r)] = r
    return table, width


_MC_TABLE, _MC_TABLE_WIDTH = _build_mc_table()


def marching_cubes(
    volume: np.ndarray,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    gradient_direction: str = "descent",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lookup-table marching cubes over a [X, Y, Z] scalar field.

    Returns ``(verts [V,3] float32, faces [F,3] int32, normals [V,3])``.
    Vertices are zero crossings linearly interpolated on grid edges (the
    same positions skimage produces), scaled by ``spacing``. Faces follow
    the right-hand rule with geometric normals pointing toward values above
    ``level`` — the reference's post-winding-fix orientation. ``normals``
    are field-gradient vertex normals; ``descent`` (skimage's default)
    points toward decreasing values.
    """
    volume = np.ascontiguousarray(volume, dtype=np.float64)
    nx, ny, nz = volume.shape
    assert min(nx, ny, nz) >= 2, "volume must be at least 2 voxels per axis"
    inside = volume < level

    # per-cube configuration index
    ci = np.zeros((nx - 1, ny - 1, nz - 1), dtype=np.int64)
    for c, (ox, oy, oz) in enumerate(_MC_CORNERS):
        ci |= (
            inside[ox : nx - 1 + ox, oy : ny - 1 + oy, oz : nz - 1 + oz]
            .astype(np.int64) << c
        )

    # crossing edges per axis family; global edge ids = family offset + flat
    shapes = [(nx - 1, ny, nz), (nx, ny - 1, nz), (nx, ny, nz - 1)]
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.cumsum([0] + sizes[:-1])
    verts_list, ids_list = [], []
    for axis in range(3):
        sl1 = tuple(
            slice(0, -1) if a == axis else slice(None) for a in range(3)
        )
        sl2 = tuple(
            slice(1, None) if a == axis else slice(None) for a in range(3)
        )
        v1, v2 = volume[sl1], volume[sl2]
        cross = inside[sl1] != inside[sl2]
        idx = np.argwhere(cross)  # [M, 3] base grid coords
        t = (level - v1[cross]) / (v2[cross] - v1[cross])
        pos = idx.astype(np.float64)
        pos[:, axis] += t
        verts_list.append(pos)
        ids_list.append(
            offsets[axis] + np.ravel_multi_index(idx.T, shapes[axis])
        )
    verts = np.concatenate(verts_list, axis=0)
    flat_ids = np.concatenate(ids_list, axis=0)
    id_map = np.full(sum(sizes), -1, dtype=np.int64)
    id_map[flat_ids] = np.arange(len(flat_ids))

    # active cubes -> triangles
    ci_flat = ci.reshape(-1)
    active = np.flatnonzero((ci_flat != 0) & (ci_flat != 255))
    if len(active) == 0 or len(verts) == 0:
        z3 = np.zeros((0, 3), np.float32)
        return z3, np.zeros((0, 3), np.int32), z3
    ax_, ay_, az_ = np.unravel_index(active, ci.shape)
    # global flat edge id of each of the 12 local edges, per active cube
    e12 = np.empty((len(active), 12), dtype=np.int64)
    for e, (axis, (ox, oy, oz)) in enumerate(_MC_EDGE_GRID):
        e12[:, e] = offsets[axis] + np.ravel_multi_index(
            (ax_ + ox, ay_ + oy, az_ + oz), shapes[axis]
        )
    entries = _MC_TABLE[ci_flat[active]]  # [A, W] int8 local edge ids
    rows, cols = np.nonzero(entries >= 0)
    tri_edges = e12[rows, entries[rows, cols].astype(np.int64)]
    faces = id_map[tri_edges].reshape(-1, 3).astype(np.int32)
    assert (faces >= 0).all()

    # gradient vertex normals (trilinear sample of central differences)
    grad = np.stack(np.gradient(volume), axis=-1)  # [X, Y, Z, 3]
    base = np.minimum(verts.astype(np.int64), [nx - 2, ny - 2, nz - 2])
    frac = verts - base
    normals = np.zeros((len(verts), 3))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (frac[:, 0] if dx else 1 - frac[:, 0])
                    * (frac[:, 1] if dy else 1 - frac[:, 1])
                    * (frac[:, 2] if dz else 1 - frac[:, 2])
                )
                normals += w[:, None] * grad[
                    base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz
                ]
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals /= np.where(norm < 1e-12, 1.0, norm)
    if gradient_direction == "descent":
        normals = -normals
    elif gradient_direction != "ascent":
        raise ValueError(f"unknown gradient_direction: {gradient_direction}")

    verts = verts * np.asarray(spacing, dtype=np.float64)
    return verts.astype(np.float32), faces, normals.astype(np.float32)


# --------------------------------------------------------------------------
# Marching tetrahedra
# --------------------------------------------------------------------------

# Cube corners numbered idx = cx + 2*cy + 4*cz over these offsets:
_CORNER_OFFSETS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
    ],
    dtype=np.int32,
)
# A consistent 6-tetrahedra split of the cube, all sharing the 0-7 diagonal:
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int32,
)


def _interp(p1, p2, v1, v2, level):
    t = (level - v1) / np.where(np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p1 + t * (p2 - p1)


def marching_tetrahedra(
    volume: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a 3D scalar field.

    volume: [X, Y, Z] float array (values at integer grid coordinates).
    Returns (verts [V, 3] in index coordinates, faces [F, 3] int32) with
    faces oriented so normals point toward decreasing field values.
    """
    volume = np.asarray(volume, dtype=np.float64)
    nx, ny, nz = volume.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # all cube origins
    gx, gy, gz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    origins = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # [C, 3]

    # corner values per cube: [C, 8]
    corner_coords = origins[:, None, :] + _CORNER_OFFSETS[None]  # [C, 8, 3]
    vals = volume[
        corner_coords[..., 0], corner_coords[..., 1], corner_coords[..., 2]
    ]

    # quick reject cubes fully on one side
    keep = ~(
        np.all(vals > level, axis=1) | np.all(vals < level, axis=1)
    )
    corner_coords = corner_coords[keep].astype(np.float64)
    vals = vals[keep]
    if len(vals) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    tris = []
    for tet in _TETS:
        p = corner_coords[:, tet, :]  # [C, 4, 3]
        v = vals[:, tet]  # [C, 4]
        inside = v < level  # [C, 4]
        count = inside.sum(axis=1)

        # one vertex inside (or one outside): single triangle
        for flip, cnt in ((False, 1), (True, 3)):
            sel = count == cnt
            if not sel.any():
                continue
            pi, vi, ins = p[sel], v[sel], inside[sel]
            # the lone corner (inside if cnt==1 else outside)
            lone_mask = ins if cnt == 1 else ~ins
            lone_idx = np.argmax(lone_mask, axis=1)
            others = np.argsort(~lone_mask, axis=1)[:, :3]  # the 3 non-lone
            a = np.take_along_axis(pi, lone_idx[:, None, None].repeat(3, -1), 1)[:, 0]
            va = np.take_along_axis(vi, lone_idx[:, None], 1)[:, 0]
            tri_pts = []
            for j in range(3):
                b = np.take_along_axis(pi, others[:, j][:, None, None].repeat(3, -1), 1)[:, 0]
                vb = np.take_along_axis(vi, others[:, j][:, None], 1)[:, 0]
                tri_pts.append(_interp(a, b, va, vb, level))
            tri = np.stack(tri_pts, axis=1)  # [M, 3, 3]
            if flip:
                tri = tri[:, ::-1]
            tris.append(tri)

        # two inside / two outside: quad -> two triangles
        sel = count == 2
        if sel.any():
            pi, vi, ins = p[sel], v[sel], inside[sel]
            in_idx = np.argsort(~ins, axis=1)[:, :2]   # two inside corners
            out_idx = np.argsort(ins, axis=1)[:, :2]   # two outside corners

            def gp(idx):
                return np.take_along_axis(pi, idx[:, None, None].repeat(3, -1), 1)[:, 0]

            def gv(idx):
                return np.take_along_axis(vi, idx[:, None], 1)[:, 0]

            a0, a1 = gp(in_idx[:, 0]), gp(in_idx[:, 1])
            b0, b1 = gp(out_idx[:, 0]), gp(out_idx[:, 1])
            va0, va1 = gv(in_idx[:, 0]), gv(in_idx[:, 1])
            vb0, vb1 = gv(out_idx[:, 0]), gv(out_idx[:, 1])
            e00 = _interp(a0, b0, va0, vb0, level)
            e01 = _interp(a0, b1, va0, vb1, level)
            e10 = _interp(a1, b0, va1, vb0, level)
            e11 = _interp(a1, b1, va1, vb1, level)
            tris.append(np.stack([e00, e01, e11], axis=1))
            tris.append(np.stack([e00, e11, e10], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    all_tris = np.concatenate(tris, axis=0)  # [T, 3, 3]

    # drop degenerate triangles
    e1 = all_tris[:, 1] - all_tris[:, 0]
    e2 = all_tris[:, 2] - all_tris[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    all_tris = all_tris[area2 > 1e-12]

    # deduplicate vertices
    flat = all_tris.reshape(-1, 3)
    rounded = np.round(flat, 6)
    uniq, inverse = np.unique(rounded, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return uniq.astype(np.float32), faces
