"""Production and host meshes (the port of ``repro/launch/mesh.py``).

Functions, not module-level state: importing this module touches no
device.  The meshes are the single-controller
:class:`repro_torch.distributed.Mesh` of the estimation system; an
explicit device list may repeat a device, so one card can stand in for
the production layout.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.distributed.sharding import Mesh, default_devices


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """Single pod: ``(16, 16)`` over ``("data", "model")`` = 256 cards.
    Multi-pod: ``(2, 16, 16)`` over ``("pod", "data", "model")`` = 512
    cards; the pod axis folds into data parallelism.

    ``devices`` lays the mesh over an explicit list of exactly that many
    devices (which may repeat one).  Without it the mesh takes the visible
    cards, and raises ``ValueError`` when there are fewer than the layout
    needs: the layout is never shrunk.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if devices is None:
        devices = default_devices("cuda")
        if len(devices) < need:
            raise ValueError(
                f"the production mesh {shape} over {axes} needs {need} "
                f"cards, {len(devices)} are visible; pass devices= (a list "
                f"that may repeat a device) to lay it over fewer")
        devices = devices[:need]
    devices = list(devices)
    if len(devices) != need:
        raise ValueError(
            f"the production mesh {shape} over {axes} needs {need} "
            f"devices, got {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda") -> Mesh:
    """The distinct visible devices of ``device_type`` (every card, or the
    one CPU device) as ``(n // model, model)`` over ``("data",
    "model")``."""
    devices = default_devices(device_type)
    n = len(devices)
    if model < 1 or n % model:
        raise AssertionError(
            f"{n} {device_type} devices do not split into model={model}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model, model), ("data", "model"))
