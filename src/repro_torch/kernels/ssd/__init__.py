from .kernel import build, launch_count, reset_launch_count, ssd_chunked
from .ops import ssd
from .ref import ssd_chunked_ref, ssd_ref

__all__ = ["build", "launch_count", "reset_launch_count", "ssd",
           "ssd_chunked", "ssd_chunked_ref", "ssd_ref"]
