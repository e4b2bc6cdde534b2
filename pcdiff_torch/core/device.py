"""Where the port's entry points build and run: on the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`. The entry points default to ``"cuda"``; with
    no card present that raises, and the CPU is used only when asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pcdiff_torch runs on a CUDA card and none is available "
                           "(torch.cuda.is_available() is False); pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
