from .kernel import (build, flash_attention, launch_count, reset_launch_count,
                     variant)
from .ops import attention
from .ref import mha_ref

__all__ = ["attention", "build", "flash_attention", "launch_count",
           "mha_ref", "reset_launch_count", "variant"]
