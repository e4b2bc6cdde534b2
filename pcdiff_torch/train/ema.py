"""Exponential moving average of parameters.

Counterpart of :mod:`pcdiff.train.ema`. The EMA is a copy of the parameters (it never
aliases them) and is updated in place, where the JAX package builds a new tree each step.
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
    """ema <- decay * ema + (1 - decay) * params, in place, parameter by parameter."""
    for name, p in model.named_parameters():
        e = ema[name]
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))
