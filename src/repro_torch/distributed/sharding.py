"""The device mesh: ``MeshSpec``, the batch split, and the logical sharding
rules of the language models.

The port is single-controller, as the reference is: one
``Estimator.solve`` or train step in one process returns the whole result.
A :class:`Mesh` is a numpy object array of ``torch.device``\\ s with axis
names (``.shape[axis]`` and ``.axis_names`` as in ``jax.sharding.Mesh``).
Work placed on a device runs there through CUDA's asynchronous launches,
so one host thread keeps every card of a node busy; the carries and the
per-shard results travel by ``Tensor.to``.

* :class:`MeshSpec` describes the 2-D (time x batch) layout of the
  estimation system.  ``.build()`` lays devices into a :class:`Mesh`;
  ``.activate()`` makes it ambient (:func:`mesh_context`) for the
  distributed solver, which resolves its time axis with
  :func:`resolve_time_mesh`.
* An explicit device list may name a device more than once: meshes of
  ``P x cpu`` or ``P x cuda:0`` run every shard's work, carries and
  fix-ups as a mesh of P cards would, on one device (the reference's
  ``--xla_force_host_platform_device_count``).  The default list holds
  the distinct visible devices of one type: ``cuda:0..n-1``, or one
  ``cpu``.
* :func:`shard_over_batch` splits the record axis of a solve over the
  mesh's batch axis (the request-axis decomposition); time sharding is
  :func:`repro_torch.core.pscan.sharded_scan`.

The rest of the module is the reference's LOGICAL axis rules (DP/TP/EP/SP)
with divisibility fallback.  Parameters and activations carry logical axis
names ("embed", "heads", "ff", "vocab", "experts", ...);
:func:`choose_pspec` maps a logical shape to a :class:`PartitionSpec` for
the ambient mesh:

* exactly one dimension is model-sharded, the first logical axis in
  ``MODEL_PRIORITY`` that is present, not excluded (``tp_exclude``), and
  whose size the model axis divides and is at least (llava's 56 q-heads do
  not divide 16 and fall through to the 128 head_dim; granite's 40 experts
  fall through to d_ff);
* "batch" (and the optimizer state's "zero1") shards over the data axes
  ("pod", "data" by default), falling back to fewer of them when the
  dimension does not divide their product;
* "seq_sp" (sequence parallelism, opt-in) goes to the model axis.

A :class:`NamedSharding` pairs a mesh with a spec: it gives the local shard
shape of a global shape and the slice each mesh position holds.
:mod:`repro_torch.distributed.spmd` executes programs on tensors laid out
by them.  A multi-host mesh would need one process per host and
``torch.distributed``; this module holds a single process's devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
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

    @property
    def size(self) -> int:
        return self.devices.size

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


# priority of logical axes for the single model-sharded dimension
MODEL_PRIORITY: Sequence[str] = (
    "experts", "vocab", "ff", "heads", "kv_heads", "ssm_inner", "ssm_x",
    "ssm_heads", "head", "embed_model",
)

# logical axes that shard over the data (+pod) axes
BATCH_AXES = ("batch",)

# logical axes that may shard over the model axis for sequence parallelism
# (opt-in)
SEQ_AXES = ("seq_sp",)


class _MeshContext(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.data_axes: tuple = ("data",)
        self.model_axis: Optional[str] = "model"
        self.tp_exclude: frozenset = frozenset()


_CTX = _MeshContext()


@contextlib.contextmanager
def mesh_context(mesh: Mesh, *, batch_axes: Optional[tuple] = None,
                 tp_exclude=()):
    """Make ``mesh`` the ambient mesh of this thread.

    ``batch_axes`` names the mesh axes that shard the batch (the record
    axis of a solve, an LM batch, the ZeRO-1 optimizer state; default:
    ``"pod"`` and ``"data"`` where present), e.g. ``("pod", "data",
    "model")`` for the dp-only policy of small models.  The model axis is
    ``"model"`` where the mesh has one; ``tp_exclude`` removes logical
    names from the model-sharding priority (e.g. everything but "vocab"
    under dp-only).
    """
    prev = (_CTX.mesh, _CTX.data_axes, _CTX.model_axis, _CTX.tp_exclude)
    _CTX.mesh = mesh
    names = mesh.axis_names
    _CTX.data_axes = tuple(a for a in (("pod", "data") if batch_axes is None
                                       else batch_axes) if a in names)
    _CTX.model_axis = "model" if "model" in names else None
    _CTX.tp_exclude = frozenset(tp_exclude)
    try:
        yield mesh
    finally:
        (_CTX.mesh, _CTX.data_axes, _CTX.model_axis,
         _CTX.tp_exclude) = prev


def policy_kw(policy: str) -> dict:
    """:func:`mesh_context`'s keywords for a ``ModelConfig.parallel_policy``
    (the reference's ``launch/dryrun.py`` passes the same): ``"tp"`` the
    defaults; ``"dp_only"`` the batch over every axis (``pod``, ``data``,
    ``model``) and only ``vocab``/``embed_model`` on the model axis."""
    if policy == "tp":
        return {}
    if policy == "dp_only":
        return dict(batch_axes=("pod", "data", "model"),
                    tp_exclude=frozenset(MODEL_PRIORITY)
                    - {"vocab", "embed_model"})
    raise ValueError(f"unknown parallel_policy {policy!r}")


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
                     arg_batched: Sequence):
    """Wrap ``fn`` so that its record axis spreads over
    ``mesh.shape[batch_axis]`` devices.

    ``arg_batched[i]`` says which dim of positional argument ``i`` carries
    the records, in either of two forms: the reference's booleans
    (``True``: dim 0, ``False``: shared by every shard), or an int dim or
    ``None`` (shared) per argument; a tuple argument's tensors share its
    entry, other values pass as they are.  Shard ``j`` takes the ``j``-th
    equal slice of each record dim, moves its tensors to the ``j``-th
    device along ``batch_axis`` and runs ``fn(*args, mesh=sub)`` there
    with that device current, ``sub`` being the sub-mesh at index ``j`` of
    ``batch_axis`` (so a time-sharded solver inside runs on that column of
    a 2-D mesh; a ``fn`` without a ``mesh`` keyword, as the reference's
    are, gets ``fn(*args)``).  The results are joined along dim 0 on the
    device of the first record-carrying argument.  The counterpart of the
    reference's ``shard_map`` over the batch axis, and of
    ``core.pscan.sharded_scan`` over time.
    """
    flags = [isinstance(b, bool) for b in arg_batched]
    if all(flags):
        in_axes = [0 if b else None for b in arg_batched]
    elif any(flags):
        raise TypeError(
            f"arg_batched {list(arg_batched)!r} mixes booleans with dims: "
            f"give booleans (True: the records on dim 0, False: shared) or "
            f"an int dim or None per argument")
    else:
        in_axes = list(arg_batched)
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        params = ()
    takes_mesh = any(p.name == "mesh" or p.kind is p.VAR_KEYWORD
                     for p in params)
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
            kw = {"mesh": mesh.select(batch_axis, j)} if takes_mesh else {}
            with device_scope(dev):
                outs.append(fn(*part, **kw))
        return _concat(outs, batched[0][0].device)

    return sharded


# ---------------------------------------------------------------------------
# logical sharding rules
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """How each dimension of a tensor spreads over mesh axes: one entry per
    dimension, ``None`` (replicated), an axis name, or a tuple of names
    (the first the major).  An immutable tuple, so it compares equal to a
    plain tuple (or a ``jax.sharding.PartitionSpec``) of the same
    entries; a tensor of more dimensions than entries is replicated on
    the rest."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh: Mesh, names) -> int:
    size = 1
    for n in names if isinstance(names, tuple) else (names,):
        size *= mesh.shape[n]
    return size


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`: which slice of a global
    tensor each mesh position holds.  Positions are index tuples into
    ``mesh.devices``; a dimension split over axes ``(a, b)`` is cut into
    ``size(a) * size(b)`` equal blocks, block ``i_a * size(b) + i_b`` at
    position ``(.., i_a, .., i_b, ..)``; positions that differ only on
    axes the spec does not name hold replicas."""
    mesh: Mesh
    spec: PartitionSpec
    # shapes and slices already worked out, per global shape
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    compare=False, hash=False, repr=False)

    def parts(self, ndim: int) -> tuple:
        """The number of blocks each of ``ndim`` dimensions is cut into."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(_axis_size(self.mesh, _entry_axes(e)) if e else 1
                     for e in spec[:ndim])

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of global ``shape``."""
        key = tuple(shape)
        out = self._memo.get(key)
        if out is None:
            out = []
            for n, k in zip(shape, self.parts(len(shape))):
                if n % k:
                    raise ValueError(
                        f"dimension {n} of {tuple(shape)} does not divide "
                        f"into the {k} blocks of {self.spec}")
                out.append(n // k)
            out = self._memo[key] = tuple(out)
        return out

    def index(self, position: tuple, shape) -> tuple:
        """The slices of a tensor of global ``shape`` that mesh
        ``position`` holds."""
        key = (tuple(position), tuple(shape))
        out = self._memo.get(key)
        if out is None:
            local = self.shard_shape(shape)
            out = self._memo[key] = tuple(
                slice(b * n, (b + 1) * n)
                for b, n in zip(self.blocks(position, len(shape)), local))
        return out

    def blocks(self, position: tuple, ndim: int) -> tuple:
        """The block of each of ``ndim`` dimensions that mesh ``position``
        holds."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for entry in spec[:ndim]:
            block = 0
            for a in _entry_axes(entry):
                k = self.mesh.axis_names.index(a)
                block = block * self.mesh.devices.shape[k] + position[k]
            out.append(block)
        return tuple(out)

    def holder(self, blocks: tuple, near: tuple) -> tuple:
        """The mesh position that holds ``blocks`` (one block index per
        dimension) nearest ``near``: its coordinates on the axes the spec
        names are those of the blocks, on the others ``near``'s (the
        unique position that differs from ``near`` on fewest axes)."""
        pos = list(near)
        sizes = self.mesh.devices.shape
        names = self.mesh.axis_names
        for entry, b in zip(tuple(self.spec) + (None,) * (
                len(blocks) - len(self.spec)), blocks):
            for a in reversed(_entry_axes(entry)):
                k = names.index(a)
                pos[k] = b % sizes[k]
                b //= sizes[k]
        return tuple(pos)


def choose_pspec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh: Optional[Mesh] = None) -> PartitionSpec:
    """Map logical axes to a PartitionSpec under the active mesh (the empty
    spec without one)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return PartitionSpec()
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical)} differ in length")
    entries: list = [None] * len(shape)

    # batch / ZeRO-1 axes -> the data axes, with progressive fallback to
    # fewer axes when the dimension does not divide the full product
    # (e.g. batch 256 on a 512-chip dp-only layout).
    for i, name in enumerate(logical):
        if name in BATCH_AXES + ("zero1",) and _CTX.data_axes:
            axes = tuple(_CTX.data_axes)
            while axes:
                if shape[i] % _axis_size(mesh, axes) == 0:
                    entries[i] = axes if len(axes) > 1 else axes[0]
                    break
                axes = axes[1:]

    def used_axes() -> set:
        out = set()
        for e in entries:
            out.update(_entry_axes(e))
        return out

    # sequence-parallel axis -> the model axis (megatron-style SP)
    if _CTX.model_axis is not None and _CTX.model_axis not in used_axes():
        msize = mesh.shape[_CTX.model_axis]
        for i, name in enumerate(logical):
            if name in SEQ_AXES and entries[i] is None \
                    and shape[i] % msize == 0:
                entries[i] = _CTX.model_axis
                break

    # one model-sharded dim by priority with divisibility fallback
    if _CTX.model_axis is not None and _CTX.model_axis not in used_axes():
        msize = mesh.shape[_CTX.model_axis]
        for cand in MODEL_PRIORITY:
            if cand in _CTX.tp_exclude:
                continue
            placed = False
            for i, name in enumerate(logical):
                if name == cand and entries[i] is None \
                        and shape[i] % msize == 0 and shape[i] >= msize:
                    entries[i] = _CTX.model_axis
                    placed = True
                    break
            if placed:
                break
    return PartitionSpec(*entries)


def logical_constraint(x, *logical: Optional[str]):
    """``x`` laid out by its logical axes on the ambient mesh (a
    :class:`repro_torch.distributed.spmd.ShardedTensor`); ``x`` itself
    without a mesh.  The model code calls no such pin: the executor of
    :mod:`repro_torch.distributed.spmd` places its activations itself."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from .spmd import device_put
    return device_put(x, NamedSharding(mesh, choose_pspec(x.shape, logical,
                                                          mesh)))


def named_sharding(shape, logical, mesh: Optional[Mesh] = None):
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, choose_pspec(shape, logical, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over a tree whose leaves are logical-axes
    tuples, and trees of the same structure (dicts and NamedTuples)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    items = [map_axes(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(axes_tree)]
    return (type(axes_tree)(*items) if hasattr(axes_tree, "_fields")
            else type(axes_tree)(items))


def tree_pspecs(axes_tree, shapes_tree, mesh: Optional[Mesh] = None):
    """Map a tree of logical-axes tuples + shapes to PartitionSpecs."""
    mesh = mesh or _CTX.mesh
    return map_axes(lambda ax, shp: choose_pspec(shp, ax, mesh),
                     axes_tree, shapes_tree)


def tree_shardings(axes_tree, shapes_tree, mesh: Optional[Mesh] = None):
    mesh = mesh or _CTX.mesh
    return map_axes(lambda ax, shp: NamedSharding(
        mesh, choose_pspec(shp, ax, mesh)), axes_tree, shapes_tree)
