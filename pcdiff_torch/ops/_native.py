"""Build and load the hand-written CUDA kernels of ``pcdiff_torch/csrc``, and the two
helpers every kernel wrapper's dispatch uses (:func:`stream`, :func:`needs_grad`).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled with
``nvcc`` for ``sm_90a`` into ``build/pcdiff_torch/lib<name>.so`` at the root of the
checkout (a directory that ``.gitignore`` lists) and loaded with :mod:`ctypes`; it is
rebuilt when the source or any header of ``csrc`` (``*.cuh``, on the include path) is
newer than the library. Importing this module builds nothing and needs no ``nvcc``: only
:func:`library` does, and only the CUDA branch of a kernel wrapper calls it. Each source
has its own lock, so calls of :func:`library` for several sources from several threads run
their ``nvcc``s at once. Across processes (several ranks on one card reach their first
launch together) a file lock a source in ``BUILD_DIR`` guards the check and the build: the
first process builds, the others wait for it and then load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

__all__ = ["library", "stale", "stream", "needs_grad", "build_seconds", "build_log",
           "BUILD_DIR", "CSRC_DIR"]

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
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on the CUDA ``device``, for a launch: the
    kernels run on it and do not synchronise (cheaper than building a ``torch.cuda.Stream``
    on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (None entries allowed): the
    wrappers skip their autograd node when it would not, as when sampling."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def stale(lib: Path, sources) -> bool:
    """Whether ``lib`` is missing or older than any of ``sources``."""
    return not lib.exists() or any(lib.stat().st_mtime < s.stat().st_mtime for s in sources)


@contextmanager
def _file_lock(name: str) -> Iterator[None]:
    """An exclusive ``flock`` on ``BUILD_DIR/lib<name>.lock``, held by one process at a
    time (the kernel drops it when its holder exits, however it exits)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if missing or stale: every
    ``csrc/*.cuh`` counts as a dependency of every source."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
            with _file_lock(name):
                if stale(path, [src, *sorted(CSRC_DIR.glob("*.cuh"))]):
                    _compile(name, src, path)
                lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
