"""Training of the port: the train state (AdamW + schedules), the EMA and the train step."""

from .ema import ema_update, init_ema
from .state import (
    TrainState,
    cosine_annealing_schedule,
    create_train_state,
    global_norm,
    warmup_cosine_schedule,
)
from .step import (
    draw_step_randoms,
    make_device_data_step,
    make_loss_fn,
    make_train_step,
    permute_points,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "cosine_annealing_schedule",
    "warmup_cosine_schedule",
    "init_ema",
    "ema_update",
    "make_loss_fn",
    "make_train_step",
    "make_device_data_step",
    "permute_points",
    "draw_step_randoms",
    "global_norm",
]
