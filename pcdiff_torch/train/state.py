"""Train state and optimizer construction.

Counterpart of :mod:`pcdiff.train.state`: AdamW with betas (0.9, 0.95), eps 1e-8 and
weight decay 0.01 on every parameter (``optax.adamw`` without a mask), an optional clip
to a global gradient norm first, and a cosine annealing of the learning rate from its peak
to ``eta_min`` over ``total_steps``. The schedules follow optax's step semantics: the
update at step k (counting from 0) uses lr(k). The state updates the model's parameters
in place; ``step`` counts the updates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

from ..core.device import resolve_device

__all__ = [
    "TrainState",
    "create_train_state",
    "cosine_annealing_schedule",
    "warmup_cosine_schedule",
    "global_norm",
]

Schedule = Callable[[int], float]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax_global_norm``), fp32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def cosine_annealing_schedule(peak_lr: float, total_steps: int,
                              eta_min: float = 1e-6) -> Schedule:
    """optax.cosine_decay_schedule(peak_lr, total_steps, alpha=eta_min / peak_lr):
    lr(t) = peak ((1 - alpha) (1 + cos(pi min(t, T) / T)) / 2 + alpha)."""
    if not total_steps > 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    alpha = eta_min / peak_lr

    def schedule(step: int) -> float:
        t = min(step, total_steps)
        return peak_lr * ((1 - alpha) * (0.5 * (1 + math.cos(math.pi * t / total_steps)))
                          + alpha)

    return schedule


def warmup_cosine_schedule(peak_lr: float, total_steps: int, warmup_ratio: float = 0.05,
                           lr_floor: float = 0.01) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak_lr, warmup, total_steps,
    lr_floor * peak_lr): linear from 0 to the peak over ``warmup`` steps, then a cosine
    decay to the floor over the remaining ``total_steps - warmup``."""
    warmup = max(1, int(total_steps * warmup_ratio))
    decay = cosine_annealing_schedule(peak_lr, total_steps - warmup, lr_floor * peak_lr)

    def schedule(step: int) -> float:
        if step < warmup:
            frac = 1 - min(max(step, 0), warmup) / warmup
            return (0.0 - peak_lr) * frac + peak_lr
        return decay(step - warmup)

    return schedule


@dataclass
class TrainState:
    """The model (whose parameters are the state's), its AdamW, the learning-rate
    schedule, the optional global-norm clip and the number of updates so far."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Schedule
    grad_clip: Optional[float] = None
    step: int = 0

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def apply_gradients(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update from the gradients in ``.grad`` (a missing one counts as zero, as
        optax sees it). ``grad_norm`` is their global norm, computed if not given."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            if grad_norm is None:
                grad_norm = global_norm(p.grad for p in params)
            # optax.clip_by_global_norm: g / norm * max_norm once norm >= max_norm
            clip = grad_norm >= self.grad_clip
            for p in params:
                p.grad = torch.where(clip, p.grad / grad_norm * self.grad_clip, p.grad)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, *, lr: float = 3e-4, weight_decay: float = 0.01,
                       total_steps: int = 100_000, eta_min: float = 1e-6,
                       grad_clip: Optional[float] = None, device="cuda") -> TrainState:
    """AdamW over all of ``model``'s parameters, which must lie on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    params = list(model.parameters())
    wrong = {str(p.device) for p in params if p.device.type != dev.type}
    if wrong:
        raise ValueError(f"the model's parameters lie on {sorted(wrong)}, not on {dev}")
    schedule = cosine_annealing_schedule(lr, total_steps, eta_min)
    optimizer = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.95), eps=1e-8,
                                  weight_decay=weight_decay)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      grad_clip=grad_clip)
