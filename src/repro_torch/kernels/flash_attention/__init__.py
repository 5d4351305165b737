from .kernel import (build, flash_attention, launch_count, reset_launch_count,
                     variant)
from .ops import attention, attention_trainable
from .ref import mha_ref

__all__ = ["attention", "attention_trainable", "build", "flash_attention",
           "launch_count", "mha_ref", "reset_launch_count", "variant"]
