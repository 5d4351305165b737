from . import checkpoint, data, optimizer, trainer
from .optimizer import (
    AdamWState, adamw_init, adamw_update, cosine_schedule, opt_state_axes,
)
from .trainer import Trainer, make_shardings, make_train_step

__all__ = ["AdamWState", "Trainer", "adamw_init", "adamw_update",
           "checkpoint", "cosine_schedule", "data", "make_shardings",
           "make_train_step", "opt_state_axes", "optimizer", "trainer"]
