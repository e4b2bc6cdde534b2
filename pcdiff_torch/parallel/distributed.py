"""The process group: its start, this process's identity, and host-side means.

Counterpart of :mod:`pcdiff.parallel.distributed` on ``torch.distributed``: NCCL on the
card, gloo only when the caller asks for the CPU; a world of one is a no-op, as in the JAX
package. A failed NCCL start raises: nothing falls back to gloo. Without a process group,
this process is rank 0 of a world of one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["initialize", "is_lead_host", "host_mean", "process_index", "process_count"]


def _dist():
    import torch.distributed as dist

    return dist


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda", store=None) -> None:
    """Start the default process group: ``init_method`` (``tcp://host:port``,
    ``file://path``; default ``env://``, the variables ``torchrun`` sets) or a ``store``,
    ``world_size`` and ``rank`` (default ``WORLD_SIZE``/``RANK``, else 1 and 0). NCCL when
    ``device`` is the card (each process then takes the card ``LOCAL_RANK``), gloo when it
    is the CPU. A world of one, or a group already started, is a no-op."""
    dist = _dist()
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size == 1 or dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    if store is None and init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank)


def is_lead_host() -> bool:
    """Whether this process is rank 0: the one that writes logs and checkpoints."""
    return process_index() == 0


def host_mean(value: float) -> float:
    """The mean over the processes of a host-side scalar (for logging), in fp64; the
    value itself in a world of one."""
    if process_count() == 1:
        return float(value)
    dist = _dist()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(float(value), dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return t.item() / dist.get_world_size()
