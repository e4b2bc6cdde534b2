"""The one place where the diffusion layer draws standard normals.

Every solver, sampling loop and bound evaluation of :mod:`pcdiff_torch.diffusion` draws
its noise through :func:`normal`, from the caller's generator on the caller's device, so
that a test can replace this function and feed another stream's draws in their order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def normal(shape: Sequence[int], generator: Optional[torch.Generator], device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals of ``shape`` from ``generator`` (torch's default generator of
    ``device`` when None)."""
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
