from . import checkpoint, data, optimizer, trainer
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_schedule
from .trainer import Trainer, make_train_step

__all__ = ["AdamWState", "Trainer", "adamw_init", "adamw_update",
           "checkpoint", "cosine_schedule", "data", "make_train_step",
           "optimizer", "trainer"]
