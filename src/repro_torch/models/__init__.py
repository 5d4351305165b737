"""LM model stack (the parts ported so far: attention, SSM, hybrid)."""
from . import attention, layers, ssm, transformer
from .transformer import decode_step, init, init_caches, prefill

__all__ = ["attention", "layers", "ssm", "transformer", "decode_step",
           "init", "init_caches", "prefill"]
