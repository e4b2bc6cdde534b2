"""Build and load the hand-written CUDA kernels of ``pcdiff_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled with
``nvcc`` for ``sm_90a`` into ``build/pcdiff_torch/lib<name>.so`` at the root of the
checkout (a directory that ``.gitignore`` lists) and loaded with :mod:`ctypes`; it is
rebuilt when the source is newer than the library. Importing this module builds
nothing and needs no ``nvcc``: only :func:`library` does, and only the CUDA branch of a
kernel wrapper calls it. Each source has its own lock, so calls of :func:`library` for
several sources from several threads run their ``nvcc``s at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build_seconds", "build_log", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pcdiff_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

build_seconds: dict[str, float] = {}  # name -> seconds nvcc took in this process
build_log: dict[str, str] = {}  # name -> nvcc's diagnostics (ptxas register/smem report)
_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA kernels of "
            "pcdiff_torch are built from source at first use")
    return found


def _compile(name: str, src: Path, lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if missing or stale."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
            if not path.exists() or path.stat().st_mtime < src.stat().st_mtime:
                _compile(name, src, path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
