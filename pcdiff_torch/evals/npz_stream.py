"""Streaming reader for (possibly sharded) npz sample batches.

The port's own copy of :mod:`pcdiff.evals.npz_stream` (numpy): glob paths with an
optional ``[:N]`` slice, npy headers read without loading the arrays, fixed-size batches
across shard files, and a streaming zip reader that loads a fortran-ordered or object
array whole instead.
"""

from __future__ import annotations

import glob as globlib
import os
import re
import zipfile
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["NumpyArrayInfo", "NpzStreamer"]


def _read_npy_header(arr_f):
    version = np.lib.format.read_magic(arr_f)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(arr_f)
    if version == (2, 0):
        return np.lib.format.read_array_header_2_0(arr_f)
    raise ValueError(f"unknown numpy array version: {version}")


@dataclass
class NumpyArrayInfo:
    """Name/dtype/shape of one array inside an npz, read from headers only."""

    name: str
    dtype: np.dtype
    shape: Tuple[int, ...]

    @classmethod
    def infos_from_first_file(cls, glob_path: str) -> Dict[str, "NumpyArrayInfo"]:
        paths, _ = _npz_paths_and_length(glob_path)
        return cls.infos_from_file(paths[0])

    @classmethod
    def infos_from_file(cls, npz_path: str) -> Dict[str, "NumpyArrayInfo"]:
        if not os.path.exists(npz_path):
            raise FileNotFoundError(f"npz sample batch does not exist: {npz_path}")
        results = {}
        with open(npz_path, "rb") as f, zipfile.ZipFile(f, "r") as zf:
            for name in zf.namelist():
                if not name.endswith(".npy"):
                    continue
                with zf.open(name, "r") as arr_f:
                    shape, _, dtype = _read_npy_header(arr_f)
                key = name[: -len(".npy")]
                results[key] = cls(name=key, dtype=dtype, shape=shape)
        return results

    @property
    def elem_shape(self) -> Tuple[int, ...]:
        return self.shape[1:]

    def validate(self) -> None:
        if self.name in {"R", "G", "B"}:
            if len(self.shape) != 2:
                raise ValueError(
                    f"expecting exactly 2-D shape for {self.name!r} but got: {self.shape}"
                )
        elif self.name == "arr_0":
            if len(self.shape) < 2:
                raise ValueError(f"expecting at least 2-D shape but got: {self.shape}")


def _npz_paths_and_length(glob_path: str) -> Tuple[List[str], Optional[int]]:
    m = re.match(r"^(.*)\[:([0-9]*)\]$", glob_path)
    raw_path, max_count = (m[1], int(m[2])) if m else (glob_path, None)
    paths = sorted(globlib.glob(raw_path))
    if not paths:
        raise ValueError(f"no paths found matching: {glob_path}")
    return paths, max_count


class _StreamingReader:
    def __init__(self, arr_f, shape, dtype):
        self.arr_f, self.shape, self.dtype = arr_f, shape, dtype
        self.idx = 0

    def read_batch(self, batch_size: int) -> Optional[np.ndarray]:
        if self.idx >= self.shape[0]:
            return None
        bs = min(batch_size, self.shape[0] - self.idx)
        self.idx += bs
        if self.dtype.itemsize == 0:
            return np.ndarray([bs, *self.shape[1:]], dtype=self.dtype)
        count = bs * int(np.prod(self.shape[1:]))
        size = count * self.dtype.itemsize
        data = b""
        while len(data) < size:
            chunk = self.arr_f.read(size - len(data))
            if not chunk:
                raise ValueError(
                    f"EOF reading array data: expected {size}, got {len(data)}"
                )
            data += chunk
        return np.frombuffer(data, dtype=self.dtype).reshape(bs, *self.shape[1:])


class _MemoryReader:
    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.idx = 0

    @classmethod
    def load(cls, path: str, name: str) -> "_MemoryReader":
        with open(path, "rb") as f:
            return cls(np.load(f)[name])

    def read_batch(self, batch_size: int) -> Optional[np.ndarray]:
        if self.idx >= self.arr.shape[0]:
            return None
        out = self.arr[self.idx : self.idx + batch_size]
        self.idx += batch_size
        return out


@contextmanager
def _open_readers(path: str, names: Sequence[str]):
    if not names:
        yield []
        return
    with open(path, "rb") as f, zipfile.ZipFile(f, "r") as zf:
        if f"{names[0]}.npy" not in zf.namelist():
            raise ValueError(f"missing {names[0]} in npz file")
        with zf.open(f"{names[0]}.npy", "r") as arr_f:
            try:
                shape, fortran, dtype = _read_npy_header(arr_f)
                reader = (
                    _MemoryReader.load(path, names[0])
                    if fortran or dtype.hasobject
                    else _StreamingReader(arr_f, shape, dtype)
                )
            except ValueError:
                reader = _MemoryReader.load(path, names[0])
            with _open_readers(path, names[1:]) as rest:
                yield [reader] + rest


class NpzStreamer:
    """Stream fixed-size dict batches across sharded npz files."""

    def __init__(self, glob_path: str):
        self.paths, self.trunc_length = _npz_paths_and_length(glob_path)
        self.infos = NumpyArrayInfo.infos_from_file(self.paths[0])

    def keys(self) -> List[str]:
        return list(self.infos.keys())

    def stream(
        self, batch_size: int, keys: Optional[Sequence[str]] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        keys = list(keys if keys is not None else self.keys())
        cur: Optional[Dict[str, np.ndarray]] = None
        remaining = self.trunc_length
        for path in self.paths:
            if remaining is not None and remaining <= 0:
                break
            with _open_readers(path, keys) as readers:
                while remaining is None or remaining > 0:
                    want = batch_size - (len(next(iter(cur.values()))) if cur else 0)
                    if remaining is not None:
                        want = min(want, remaining)
                    batches = [r.read_batch(want) for r in readers]
                    if any(b is None for b in batches):
                        if not all(b is None for b in batches):
                            raise RuntimeError(
                                "ragged npz: element counts differ across keys"
                            )
                        break
                    if any(len(b) != len(batches[0]) for b in batches):
                        raise RuntimeError(
                            "ragged npz: element counts differ across keys"
                        )
                    got = dict(zip(keys, batches))
                    if remaining is not None:
                        remaining -= len(batches[0])
                    cur = (
                        got
                        if cur is None
                        else {
                            k: np.concatenate([cur[k], v], axis=0)
                            for k, v in got.items()
                        }
                    )
                    if len(next(iter(cur.values()))) == batch_size:
                        yield cur
                        cur = None
        if cur is not None:
            yield cur
