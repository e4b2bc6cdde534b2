"""Exponential moving average of parameters.

Counterpart of :mod:`pcdiff.train.ema`. The EMA is a copy of the parameters (it never
aliases them) and is updated in place, where the JAX package builds a new tree each step.
The update runs on PyTorch's multi-tensor (``_foreach``) ops: a few launches for all the
parameters, where one tensor at a time would take four launches each (about 5000 for the
flagship's 1239 tensors). Each element sees the same three roundings either way.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

__all__ = ["init_ema", "ema_update"]


@torch.no_grad()
def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA state: a copy of every parameter, by name."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, over every parameter."""
    named = list(model.named_parameters())
    shadow = [ema[name] for name, _ in named]
    scaled = torch._foreach_mul([p.to(e.dtype) for (_, p), e in zip(named, shadow)],
                                1.0 - decay)
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, scaled)
