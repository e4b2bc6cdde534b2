"""The native host-side FPS of ``native/fps.cpp``, through ctypes.

Counterpart of :mod:`pcdiff.geometry.fps_native`, the deterministic-mode FPS of the host
data-preparation paths (the downsampling tool), where sending every chunk to the card is
wasteful. The JAX package loads a ``native/libfps.so`` built beforehand; the port builds
``native/fps.cpp`` itself with the host's C++ compiler (``g++``) at first use, into
``build/pcdiff_torch/libfps.so`` (rebuilt when the source is newer), and loads it. It is
compiled with ``-ffp-contract=off``: each squared distance is then summed channel by
channel without fused multiply-adds, as the card's FPS (:mod:`pcdiff_torch.geometry.fps`)
sums it, so the two agree index for index. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["native_fps_indices", "native_available"]

_ROOT = Path(__file__).resolve().parents[2]  # the checkout
SOURCE = _ROOT / "native" / "fps.cpp"
BUILD_DIR = _ROOT / "build" / "pcdiff_torch"
LIBRARY = BUILD_DIR / "libfps.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lib = None
_lock = threading.Lock()


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def native_available() -> bool:
    """Whether this machine has the host compiler that builds the library."""
    return _compiler() is not None


def _build(cxx: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, LIBRARY)


def _load():
    """The loaded library, built first where it is missing or older than its source;
    None where there is no host compiler. A build that fails raises."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            if cxx is None:
                return None
            if (not LIBRARY.exists()
                    or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
                _build(cxx)
            lib = ctypes.CDLL(str(LIBRARY))
            lib.fps_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.fps_batch.restype = None
            _lib = lib
    return _lib


def native_fps_indices(points: np.ndarray, num_samples: int,
                       starts: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Deterministic FPS indices [B, M] (int32) of ``points`` [B, N, C] (taken as fp32),
    or None where the library cannot be built (no host compiler). Index-exact with
    :func:`pcdiff_torch.geometry.fps.farthest_point_sample` with ``deterministic=True``
    (start b % N, the first argmax on ties); ``starts`` [B] gives other starts, as a
    chunked caller's positions do."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 3 or pts.shape[1] == 0:
        raise ValueError(f"points must be [B, N > 0, C], got {pts.shape}")
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")
    b, n, c = pts.shape
    if starts is None:
        starts = np.arange(b, dtype=np.int32) % n
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    if starts.shape != (b,) or starts.min(initial=0) < 0:
        raise ValueError(f"starts must be [{b}] non-negative indices, got {starts}")
    lib = _load()
    if lib is None:
        return None
    out = np.empty((b, num_samples), dtype=np.int32)
    lib.fps_batch(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, n, c, num_samples,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
