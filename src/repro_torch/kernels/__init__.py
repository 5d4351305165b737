"""Hand-written CUDA kernels of the port (one subpackage per kernel).
Importing them builds nothing: each library is compiled at its first
launch."""
from . import flash_attention, lqt_combine, ssd

__all__ = ["flash_attention", "lqt_combine", "ssd"]
