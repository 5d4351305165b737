"""The device mesh of the estimation system: ``MeshSpec`` and the batch split.

The port is single-controller, as the reference is: one
``Estimator.solve`` in one process returns the whole ``Solution``.  A
:class:`Mesh` is a numpy object array of ``torch.device``\\ s with axis
names (``.shape[axis]`` and ``.axis_names`` as in ``jax.sharding.Mesh``).
Work placed on a device runs there through CUDA's asynchronous launches,
so one host thread keeps every card of a node busy; the carries and the
per-shard results travel by ``Tensor.to``.

* :class:`MeshSpec` describes the 2-D (time x batch) layout.
  ``.build()`` lays devices into a :class:`Mesh`; ``.activate()`` makes it
  ambient (:func:`mesh_context`) for the distributed solver, which
  resolves its time axis with :func:`resolve_time_mesh`.
* An explicit device list may name a device more than once: meshes of
  ``P x cpu`` or ``P x cuda:0`` run every shard's work, carries and
  fix-ups as a mesh of P cards would, on one device (the reference's
  ``--xla_force_host_platform_device_count``).  The default list holds
  the distinct visible devices of one type: ``cuda:0..n-1``, or one
  ``cpu``.
* :func:`shard_over_batch` splits the record axis of a solve over the
  mesh's batch axis (the request-axis decomposition); time sharding is
  :func:`repro_torch.core.pscan.sharded_scan`.

A multi-host mesh would need one process per host and
``torch.distributed``; this module holds a single process's devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def canonical_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``"cuda"`` names card 0."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


class Mesh:
    """A named array of ``torch.device``\\ s, which may repeat a device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        arr = np.empty(devices.size, dtype=object)
        arr[:] = [canonical_device(d) for d in devices.flat]
        self.devices = arr.reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"devices of shape {self.devices.shape} need one axis name "
                f"per dimension, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names must differ, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0
                    for i in range(self.devices.ndim))
        return list(self.devices[idx])

    def select(self, axis: str, index: int) -> "Mesh":
        """The sub-mesh at ``index`` of ``axis`` (kept as a size-1 axis)."""
        k = self.axis_names.index(axis)
        return Mesh(np.take(self.devices, [index], axis=k), self.axis_names)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def default_devices(device_type: str = "cuda") -> list:
    """The distinct visible devices of ``device_type``: every card, or the
    one CPU device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


class _MeshContext(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.data_axes: tuple = ("data",)


_CTX = _MeshContext()


@contextlib.contextmanager
def mesh_context(mesh: Mesh, *, batch_axes: Optional[tuple] = None):
    """Make ``mesh`` the ambient mesh of this thread; ``batch_axes`` names
    the mesh axes that shard the record axis (default: ``"pod"`` and
    ``"data"`` where present)."""
    prev = (_CTX.mesh, _CTX.data_axes)
    _CTX.mesh = mesh
    names = mesh.axis_names
    _CTX.data_axes = tuple(a for a in (batch_axes or ("pod", "data"))
                           if a in names)
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.data_axes = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def data_parallel_size(mesh: Optional[Mesh] = None) -> int:
    """Devices the record axis spreads over on ``mesh`` (default: the
    ambient one), by the ambient batch axes."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _CTX.data_axes
                     if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One declarative description of the 2-D (time x batch) device mesh.

    ``time`` devices shard the TIME axis (``method="distributed"``,
    :func:`repro_torch.core.pscan.sharded_scan`); ``batch`` devices shard
    the RECORD axis (stacked problems, engine waves).  Either may be 1:
    the axis is still named, so one spec serves time-only, batch-only and
    2-D layouts.  Pass it wherever a ``mesh=`` argument is accepted
    (``Estimator``, ``TrajectoryEngine``, ``StreamingEngine``, the
    ``map_estimate*`` shims) or enter ``.activate()``.
    """

    time: int = 1
    batch: int = 1
    time_axis: str = "time"
    batch_axis: str = "data"

    def __post_init__(self) -> None:
        for field, v in (("time", self.time), ("batch", self.batch)):
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"MeshSpec.{field} must be a positive int, got {v!r}")
        for field, v in (("time_axis", self.time_axis),
                         ("batch_axis", self.batch_axis)):
            if not isinstance(v, str) or not v:
                raise ValueError(
                    f"MeshSpec.{field} must be a non-empty str, got {v!r}")
        if self.time_axis == self.batch_axis:
            raise ValueError(
                f"time_axis and batch_axis must differ, both "
                f"{self.time_axis!r}")

    @property
    def num_devices(self) -> int:
        return self.time * self.batch

    def build(self, devices: Optional[Sequence] = None, *,
              device_type: str = "cuda") -> Mesh:
        """The :class:`Mesh` ``(time, batch)`` over ``(time_axis,
        batch_axis)`` on the first ``time * batch`` of ``devices``
        (default: :func:`default_devices` of ``device_type``); an explicit
        list may repeat a device."""
        devices = (default_devices(device_type) if devices is None
                   else list(devices))
        need = self.num_devices
        if need > len(devices):
            raise ValueError(
                f"MeshSpec needs {need} devices "
                f"({self.time} x {self.batch}), only {len(devices)} "
                f"available")
        arr = np.empty(need, dtype=object)
        arr[:] = devices[:need]
        return Mesh(arr.reshape(self.time, self.batch),
                    (self.time_axis, self.batch_axis))

    def activate(self, devices: Optional[Sequence] = None, *,
                 device_type: str = "cuda"):
        """Context manager: build the mesh and enter :func:`mesh_context`
        so the distributed solver (:func:`resolve_time_mesh`) sees it."""
        return mesh_context(self.build(devices, device_type=device_type),
                            batch_axes=(self.batch_axis,))


def as_mesh(mesh, *, device_type: str = "cuda") -> Optional[Mesh]:
    """Normalise the public ``mesh=`` argument: ``None`` | :class:`Mesh` |
    :class:`MeshSpec` (built on the default devices of ``device_type``)
    -> ``Optional[Mesh]``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, MeshSpec):
        return mesh.build(device_type=device_type)
    raise TypeError(
        f"mesh must be None, a repro_torch.distributed.Mesh or a MeshSpec, "
        f"got {type(mesh).__name__}")


def mesh_fingerprint(mesh: Optional[Mesh]) -> Optional[Tuple]:
    """A hashable identity of a mesh: axis names, shape, device type and
    the device indices, so a mesh that repeats a device differs from one
    of distinct devices."""
    if mesh is None:
        return None
    flat = list(mesh.devices.flat)
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            flat[0].type, tuple(d.index for d in flat))


def resolve_time_mesh(time_axis: str, *,
                      devices_per_time: Optional[int] = None,
                      mesh: Optional[Mesh] = None,
                      device_type: str = "cuda") -> Optional[Mesh]:
    """The mesh a time-sharded solve runs under.

    An explicit ``mesh`` carrying ``time_axis``, else the ambient
    :func:`mesh_context` mesh carrying it, else a 1-D mesh over
    ``devices_per_time`` distinct devices of ``device_type`` (all of them
    when ``None``).  Returns ``None`` when fewer than 2 time shards are
    available: the caller falls back or raises
    (``DistributedOptions.fallback``).
    """
    for candidate in (mesh, _CTX.mesh):
        if candidate is not None and time_axis in candidate.axis_names:
            if (devices_per_time is not None
                    and candidate.shape[time_axis] != devices_per_time):
                raise ValueError(
                    f"devices_per_time={devices_per_time} but the mesh's "
                    f"{time_axis!r} axis has size "
                    f"{candidate.shape[time_axis]}")
            return candidate
    devices = default_devices(device_type)
    n = len(devices) if devices_per_time is None else devices_per_time
    if n > len(devices):
        raise ValueError(
            f"devices_per_time={n} exceeds the {len(devices)} available "
            f"devices")
    if n < 2:
        return None
    return Mesh(devices[:n], (time_axis,))


def device_scope(device: torch.device):
    """Make ``device`` the current CUDA device (kernels size their launch
    from it); a no-op for other devices."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split(a, axis: Optional[int], j: int, n: int, device):
    if isinstance(a, tuple):
        return type(a)(_split(x, axis, j, n, device) for x in a)
    if not isinstance(a, torch.Tensor):
        return a
    if axis is not None:
        size = a.shape[axis] // n
        a = a.narrow(axis, j * size, size)
    return a.to(device)


def _concat(outs: list, home: torch.device):
    """Join per-shard results (tensors, tuples, dataclasses of them) along
    dim 0 on ``home``; other leaves are taken from the first shard."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(home) for o in outs])
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _concat([getattr(o, f.name) for o in outs], home)
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, tuple):
        parts = [_concat(list(xs), home) for xs in zip(*outs)]
        return (type(first)(*parts) if hasattr(first, "_fields")
                else tuple(parts))
    return first


def shard_over_batch(fn, mesh: Mesh, batch_axis: str,
                     in_axes: Sequence[Optional[int]]):
    """Wrap ``fn`` so that its record axis spreads over
    ``mesh.shape[batch_axis]`` devices.

    ``in_axes[i]`` is the dim of positional argument ``i`` that carries
    the records (``None``: shared by every shard; a tuple argument's
    tensors share its entry; other values pass as they are).  Shard ``j``
    takes the ``j``-th equal slice of each record dim, moves its tensors
    to the ``j``-th device along ``batch_axis`` and runs
    ``fn(*args, mesh=sub)`` there with that device current, ``sub`` being
    the sub-mesh at index ``j`` of ``batch_axis`` (so a time-sharded
    solver inside runs on that column of a 2-D mesh).  The results are
    joined along dim 0 on the device of the first record-carrying
    argument.  The counterpart of the reference's ``shard_map`` over the
    batch axis, and of ``core.pscan.sharded_scan`` over time.
    """
    devices = mesh.axis_devices(batch_axis)
    n = len(devices)

    def sharded(*args):
        batched = [(a, ax) for a, ax in zip(args, in_axes)
                   if ax is not None and isinstance(a, torch.Tensor)]
        size = batched[0][0].shape[batched[0][1]]
        if size % n:
            raise ValueError(
                f"batch {size} not divisible by mesh batch axis size {n}")
        outs = []
        for j, dev in enumerate(devices):
            part = [_split(a, ax, j, n, dev) for a, ax in zip(args, in_axes)]
            with device_scope(dev):
                outs.append(fn(*part, mesh=mesh.select(batch_axis, j)))
        return _concat(outs, batched[0][0].device)

    return sharded
