"""Binary PLY files in pure Python and numpy.

The port's own copy of :mod:`pcdiff.geometry.ply`, which writes the same bytes:
binary-little-endian PLY with float vertex positions, optional uint8 colours and optional
int32 triangle faces, and a reader of what the writer writes.
"""

from __future__ import annotations

import struct
from io import BufferedIOBase
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["write_ply", "read_ply"]


def write_ply(
    raw_f: BufferedIOBase,
    coords: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
) -> None:
    """Write a binary-little-endian PLY file.

    coords: [N, 3] float; rgb: optional [N, 3] in [0, 1]; faces: optional
    [M, 3] int vertex indices.
    """
    coords = np.asarray(coords, dtype=np.float32)
    assert coords.ndim == 2 and coords.shape[1] == 3
    header = ["ply", "format binary_little_endian 1.0"]
    header.append(f"element vertex {len(coords)}")
    header += ["property float x", "property float y", "property float z"]
    if rgb is not None:
        rgb = np.asarray(rgb)
        assert rgb.shape == coords.shape
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32)
        assert faces.ndim == 2 and faces.shape[1] == 3
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_index")
    header.append("end_header")
    raw_f.write(("\n".join(header) + "\n").encode("ascii"))

    if rgb is not None:
        # 255.499 quantization matches the reference writer byte-for-byte
        rgb_u8 = np.clip(np.round(rgb * 255.499), 0, 255).astype(np.uint8)
        vert_fmt = "<3f3B"
        for xyz, c in zip(coords, rgb_u8):
            raw_f.write(struct.pack(vert_fmt, *xyz, *c))
    else:
        raw_f.write(coords.astype("<f4").tobytes())

    if faces is not None:
        for tri in faces:
            raw_f.write(struct.pack("<B3i", 3, *tri))


def read_ply(raw_f: BufferedIOBase) -> Dict[str, np.ndarray]:
    """Read a binary-little-endian PLY written by :func:`write_ply`.

    Returns dict with ``coords`` [N,3] f32, optionally ``rgb`` [N,3] in [0,1]
    and ``faces`` [M,3] i32.
    """
    def _readline() -> str:
        line = b""
        while not line.endswith(b"\n"):
            ch = raw_f.read(1)
            if not ch:
                raise ValueError("unexpected EOF in PLY header")
            line += ch
        return line.decode("ascii").strip()

    if _readline() != "ply":
        raise ValueError("not a PLY file")
    if _readline() != "format binary_little_endian 1.0":
        raise ValueError("only binary_little_endian PLY is supported")

    n_vertex = n_face = 0
    vertex_props: list[Tuple[str, str]] = []
    current = None
    while True:
        line = _readline()
        if line == "end_header":
            break
        parts = line.split()
        if parts[0] == "element":
            current = parts[1]
            if current == "vertex":
                n_vertex = int(parts[2])
            elif current == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and current == "vertex":
            vertex_props.append((parts[1], parts[2]))

    prop_names = [name for _, name in vertex_props]
    has_rgb = "red" in prop_names
    fmt = "<" + "".join("f" if t == "float" else "B" for t, _ in vertex_props)
    size = struct.calcsize(fmt)
    raw = raw_f.read(n_vertex * size)
    rows = [struct.unpack_from(fmt, raw, i * size) for i in range(n_vertex)]
    arr = np.array(rows, dtype=np.float64)
    xyz_cols = [prop_names.index(c) for c in ("x", "y", "z")]
    out: Dict[str, np.ndarray] = {"coords": arr[:, xyz_cols].astype(np.float32)}
    if has_rgb:
        rgb_cols = [prop_names.index(c) for c in ("red", "green", "blue")]
        out["rgb"] = (arr[:, rgb_cols] / 255.0).astype(np.float32)
    if n_face:
        faces = np.empty((n_face, 3), dtype=np.int32)
        for i in range(n_face):
            (cnt,) = struct.unpack("<B", raw_f.read(1))
            if cnt != 3:
                raise ValueError("only triangle faces are supported")
            faces[i] = struct.unpack("<3i", raw_f.read(12))
        out["faces"] = faces
    return out
