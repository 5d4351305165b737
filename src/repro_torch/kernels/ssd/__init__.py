from .kernel import (build, launch_count, reset_launch_count, ssd_chunked,
                     variant)
from .ops import ssd, ssd_trainable
from .ref import (bf16_split, ssd_chunked_ref, ssd_ref, ssd_scan_chunked,
                  ssd_staged_ref)

__all__ = ["bf16_split", "build", "launch_count", "reset_launch_count", "ssd",
           "ssd_chunked", "ssd_chunked_ref", "ssd_ref", "ssd_scan_chunked",
           "ssd_staged_ref", "ssd_trainable", "variant"]
