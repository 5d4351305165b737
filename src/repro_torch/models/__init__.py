"""LM model zoo: one generic stack covering every registered
architecture."""
from . import attention, layers, moe, ssm, transformer
from .transformer import (
    axes, decode_step, init, init_caches, prefill, shapes, train_loss,
)

__all__ = [
    "attention", "layers", "moe", "ssm", "transformer",
    "axes", "decode_step", "init", "init_caches", "prefill", "shapes",
    "train_loss",
]
