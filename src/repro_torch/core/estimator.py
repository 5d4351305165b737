"""The estimation surface: ``Estimator.solve(Problem) -> Solution``.

* :class:`Problem` describes WHAT to solve -- model + time grid +
  measurements (+ optional mask / information-form prior / warm start), as
  one record (:meth:`Problem.single`), records sharing a length
  (:meth:`Problem.stacked`) or records of unequal lengths
  (:meth:`Problem.ragged`, solved by pad-and-bucket).  The constructors
  validate shapes up front.
* :class:`~repro_torch.core.options.SolverOptions` subclasses describe HOW;
  each registered method owns its options dataclass.
* :class:`Estimator` binds (model, method, options, device, mesh).
  ``device`` defaults to ``"cuda"``; without a card it raises unless the
  caller asks for ``device="cpu"``.  A ``mesh``
  (:class:`repro_torch.distributed.MeshSpec`) spreads stacked records
  over its batch axis and, with ``method="distributed"``, the time axis
  over its time axis.  The estimator keeps ONE :class:`Compiled` solve per
  (problem layout, options, device, mesh) key in an LRU
  :class:`ExecutableCache` (the module-level one unless it is given its
  own; inspect it with :func:`cache_stats`).  ``.solve`` runs it;
  ``.lower(problem).compile()`` returns it for ahead-of-time use.
* :class:`~repro_torch.core.types.Solution` is the result, with the
  Onsager-Machlup cost of the estimate (and, for nonlinear models, the cost
  and step-norm traces of the iterations; for ragged problems, the
  bucket/padding report).

Nonlinear models are solved with the iterated linearisation of section
4.4 (:func:`repro_torch.core.nonlinear.iterated_solve`); wrap the inner
method options in :class:`~repro_torch.core.options.IteratedOptions` to
control the outer loop.

Records are solved together: the record batch rides as a tensor dim right
after the time axis through every stage (a single problem is a batch of
one), so each scan level is one batched operation -- one kernel launch for
``parallel_kernel`` -- over all records.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.distributed.sharding import (
    as_mesh,
    canonical_device,
    mesh_fingerprint,
    resolve_time_mesh,
    shard_over_batch,
)
from repro_torch.obs.metrics import replaying
from repro_torch.obs.tracing import trace_range

from .nonlinear import iterated_solve
from .options import (
    DistributedOptions,
    IteratedOptions,
    KernelOptions,
    SolverOptions,
)
from .padding import (
    _tensor,
    bucket_length,
    next_pow2,
    pad_record,
    slice_solution,
)
from .registry import get_method
from .sde import LinearSDE, NonlinearSDE, grid_lqt_from_linear, om_cost_grid
from .types import BucketInfo, PaddingReport, Solution

Model = Union[LinearSDE, NonlinearSDE]
Records = Sequence[Tuple[Any, Any]]


class ExecutableCache:
    """LRU cache of :class:`Compiled` solves keyed by (model, mesh, method,
    options, problem layout, device).

    Models hold tensors (unhashable), so the key uses ``id(model)``; the
    entry keeps a strong reference to the model (and mesh) so the id cannot
    be recycled while it is cached.  ``maxsize`` bounds the entries kept:
    callers that build a fresh model per request never hit and would
    otherwise grow the cache without bound -- reuse one model object to
    reuse its entries.

    Hit/miss/eviction counts are plain ints (always kept) and mirrored
    into the :mod:`repro_torch.obs` counters ``cache.hits`` /
    ``cache.misses`` / ``cache.evictions`` while obs is enabled (summed
    over every cache: the module default and any private
    ``Estimator(cache=...)`` one).  Thread-safe: the engines solve from
    their own threads.
    """

    def __init__(self, maxsize: int = 128) -> None:
        self._entries: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        self._lock = threading.RLock()
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_entry(self, model: Model, mesh, key_tail: tuple, build):
        """Fetch-or-build; returns ``(fn, fresh)``, ``fresh`` marking a miss
        (``fn`` was just built and has not run yet)."""
        key = (id(model), None if mesh is None else id(mesh)) + key_tail
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                obs.inc("cache.hits")
                return entry[0], False
            self.misses += 1
            obs.inc("cache.misses")
            fn = build()
            self._entries[key] = (fn, model, mesh)
            if len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                obs.inc("cache.evictions")
            return fn, True

    def get(self, model: Model, mesh, key_tail: tuple, build):
        return self.get_entry(model, mesh, key_tail, build)[0]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)


_CACHE = ExecutableCache()


def cache_stats() -> Dict[str, int]:
    """The default cache's counters: one miss per new (layout, method,
    options, device, mesh) entry, a hit for every reuse, an eviction for
    every LRU drop.  The obs registry exports the same counts as
    ``cache.*`` (summed over every cache), beside the
    ``cache.compile_seconds`` histogram of fresh entries' first solves."""
    return {"size": len(_CACHE), "hits": _CACHE.hits,
            "misses": _CACHE.misses, "evictions": _CACHE.evictions}


def clear_cache() -> None:
    _CACHE.clear()


def _signature(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype) for a in args)


class Compiled:
    """One cached solve: the counterpart of ``jax.stages.Compiled``.

    It fixes the problem layout (``kind``, which optional arguments it
    takes, their shapes and dtypes), the resolved method and options, the
    device and dtype the solve runs in, the resolved mesh and whether the
    records are split over its batch axis.  Call it with the problem's
    arrays in the reference's order ``(ts, y[, mask][, x_init][, S0,
    v0])``; it returns the :class:`Solution` that ``Estimator.solve``
    returns for them.  An argument whose shape or dtype differs from the
    entry's signature raises ``ValueError``.

    Its first run is the compile phase: the work done once per process and
    entry falls in it -- on the card, loading the kernel library its
    method launches (built if needed), creating the cuBLAS and cuSOLVER
    handles, growing the allocator.  Counters of
    :func:`repro_torch.obs.metrics.inc_per_entry` count on that run only.
    """

    def __init__(self, run: Callable, signature: tuple,
                 library: Optional[Callable] = None) -> None:
        self._run = run
        self.signature = signature
        self._library = library
        self._ran = False
        self._lock = threading.Lock()

    def load(self) -> None:
        """Build (if needed) and load the kernel library the solve
        launches, if it launches one."""
        if self._library is not None:
            self._library()

    def __call__(self, *args) -> Solution:
        args = tuple(_tensor(a) for a in args)
        sig = _signature(args)
        if sig != self.signature:
            raise ValueError(
                f"arguments {sig} do not match the compiled signature "
                f"{self.signature}")
        with self._lock:
            first, self._ran = not self._ran, True
        if first or not obs.enabled():
            return self._run(*args)
        with replaying():
            return self._run(*args)


class Lowered:
    """A problem layout's solve ahead of its first run (the counterpart of
    ``jax.stages.Lowered``): :meth:`compile` returns the cached
    :class:`Compiled` entry."""

    def __init__(self, compiled: Compiled) -> None:
        self._compiled = compiled

    def compile(self) -> Compiled:
        """Load the kernel libraries the solve launches; return the
        entry."""
        self._compiled.load()
        return self._compiled


def _scan_library():
    from repro_torch.kernels.lqt_combine import scan

    return scan.build()


def _device_key(device: torch.device) -> torch.device:
    """``device`` with a bare ``cuda`` resolved to the current card, which
    a solve on it runs on."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_ny(model: Model, y, where: str = "") -> None:
    """Reject measurements whose trailing dimension does not match the
    model's ``ny``: a mismatched ``y`` would otherwise broadcast silently
    against ``H x`` (skipped when ``R`` is a callable)."""
    ny = model.ny
    if ny is not None and y.shape[-1] != ny:
        raise ValueError(
            f"{where}y has measurement dimension {y.shape[-1]} but the "
            f"model's R is {ny}x{ny} (ny={ny})")


def _check_mask(mask, shape) -> torch.Tensor:
    mask = _tensor(mask)
    if tuple(mask.shape) != tuple(shape):
        raise ValueError(
            f"measurement_mask must have shape {tuple(shape)}, got "
            f"{tuple(mask.shape)}")
    if mask.dtype == torch.bool or not (mask.is_floating_point()
                                        or mask.is_complex()):
        return mask.to(torch.float64)            # 0/1 masks are welcome
    if not mask.is_floating_point():
        raise ValueError(
            f"measurement_mask must be a real 0/1 array (it scales R^-1), "
            f"got dtype {mask.dtype}")
    return mask


def _check_prior(model: Model, prior, batch: Optional[int]):
    """Validate an information-form prior override ``(S0, v0)``: shared
    ``(nx, nx)``/``(nx,)`` or, for stacked problems, per-record
    ``(B, nx, nx)``/``(B, nx)`` (both components must agree)."""
    if prior is None:
        return None
    try:
        S0, v0 = prior
    except (TypeError, ValueError):
        raise ValueError(
            "prior must be an information-form pair (S0, v0)") from None
    S0, v0 = _tensor(S0), _tensor(v0)
    nx = model.nx
    s_ok, v_ok = {(nx, nx)}, {(nx,)}
    if batch is not None:
        s_ok.add((batch, nx, nx))
        v_ok.add((batch, nx))
    if tuple(S0.shape) not in s_ok or tuple(v0.shape) not in v_ok:
        raise ValueError(
            f"prior (S0, v0) must have shapes {sorted(s_ok)} / "
            f"{sorted(v_ok)}, got {tuple(S0.shape)} / {tuple(v0.shape)}")
    if (S0.dim() == 3) != (v0.dim() == 2):
        raise ValueError(
            f"prior S0 and v0 must be both shared or both per-record, "
            f"got shapes {tuple(S0.shape)} / {tuple(v0.shape)}")
    return (S0, v0)


def _check_x_init(model: Model, x_init, N: int, batch: Optional[int]):
    """Validate a warm start of the iterated linearisation: shared
    ``(nx,)``/``(N+1, nx)`` or, for stacked problems, per-record
    ``(B, nx)``/``(B, N+1, nx)``."""
    if x_init is None:
        return None
    if not isinstance(model, NonlinearSDE):
        raise ValueError(
            "x_init is only meaningful for NonlinearSDE problems (it warm-"
            "starts the iterated linearisation)")
    x_init = _tensor(x_init)
    nx = model.nx
    shared = {(nx,), (N + 1, nx)}
    if batch is None:
        if tuple(x_init.shape) not in shared:
            raise ValueError(
                f"x_init must be ({nx},) or ({N + 1}, {nx}), "
                f"got {tuple(x_init.shape)}")
    else:
        batched = {(batch, nx), (batch, N + 1, nx)}
        if tuple(x_init.shape) not in shared | batched:
            raise ValueError(
                f"x_init must be shared ({nx},)/({N + 1}, {nx}) or "
                f"per-record ({batch}, {nx})/({batch}, {N + 1}, {nx}), "
                f"got {tuple(x_init.shape)}")
    return x_init


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """One estimation workload: model + data (+ optional mask / prior /
    warm start).

    Build via :meth:`single`, :meth:`stacked` or :meth:`ragged`; arrays
    may be tensors or anything ``numpy.array`` takes.  They are moved to
    the estimator's device and the model's dtype at solve time.  For
    ragged problems ``ts``/``y`` are tuples of per-record tensors.
    """

    model: Model
    ts: Any
    y: Any
    measurement_mask: Optional[torch.Tensor] = None
    x_init: Any = None
    prior: Any = None
    kind: str = "single"
    bucket_sizes: Optional[Tuple[int, ...]] = None
    pad_batch: bool = True

    @classmethod
    def single(cls, model: Model, ts, y, *, measurement_mask=None,
               x_init=None, prior=None) -> "Problem":
        """One record: ``ts`` ``(N+1,)``, ``y`` ``(N, ny)``; ``prior``
        ``(S0, v0)`` is an information-form initial boundary replacing the
        model's ``(m0, P0)``; ``x_init`` (nonlinear models) ``(nx,)`` or
        ``(N+1, nx)`` warm-starts the iterated linearisation."""
        ts, y = _tensor(ts), _tensor(y)
        if y.dim() != 2 or y.shape[0] < 1:
            raise ValueError(
                f"y must be (N, ny) with N >= 1, got {tuple(y.shape)}")
        N = y.shape[0]
        if tuple(ts.shape) != (N + 1,):
            raise ValueError(
                f"ts must be (N+1,) = {(N + 1,)}, got {tuple(ts.shape)}")
        _check_ny(model, y)
        if measurement_mask is not None:
            measurement_mask = _check_mask(measurement_mask, (N,))
        x_init = _check_x_init(model, x_init, N, None)
        prior = _check_prior(model, prior, None)
        return cls(model, ts, y, measurement_mask, x_init, prior,
                   kind="single")

    @classmethod
    def stacked(cls, model: Model, ts, ys, *, measurement_mask=None,
                x_init=None, prior=None) -> "Problem":
        """Stacked records ``ys`` ``(B, N, ny)`` sharing the interval
        count; ``ts`` shared ``(N+1,)`` or per-record ``(B, N+1)``;
        ``prior`` shared or per-record (see :meth:`single`).

        ``x_init`` (nonlinear models): shared ``(nx,)`` / ``(N+1, nx)``
        or per-record ``(B, nx)`` / ``(B, N+1, nx)``.  If ``B == N+1``
        makes a rank-2 shape ambiguous, the per-record reading wins --
        tile to ``(B, N+1, nx)`` to force a shared trajectory."""
        ys = _tensor(ys)
        if ys.dim() != 3:
            raise ValueError(f"ys must be (B, N, ny), got shape "
                             f"{tuple(ys.shape)}")
        ts = _tensor(ts)
        B, N = ys.shape[0], ys.shape[1]
        if ts.shape[-1] != N + 1:
            raise ValueError(
                f"ts has {ts.shape[-1]} points but ys has {N} intervals "
                f"(need N+1 = {N + 1})")
        if ts.dim() == 2 and ts.shape[0] != B:
            raise ValueError(f"ts batch {ts.shape[0]} != ys batch {B}")
        if ts.dim() not in (1, 2):
            raise ValueError(f"ts must be (N+1,) or (B, N+1), got "
                             f"{tuple(ts.shape)}")
        _check_ny(model, ys)
        if measurement_mask is not None:
            measurement_mask = _check_mask(measurement_mask, (B, N))
        x_init = _check_x_init(model, x_init, N, B)
        prior = _check_prior(model, prior, B)
        return cls(model, ts, ys, measurement_mask, x_init, prior,
                   kind="stacked")

    @classmethod
    def ragged(cls, model: Model, records: Records, *, x_init=None,
               prior=None, bucket_sizes: Optional[Sequence[int]] = None,
               pad_batch: bool = True) -> "Problem":
        """Records of unequal length: ``records`` is a sequence of
        ``(ts_i, y_i)`` pairs with ``ts_i`` ``(N_i+1,)``, ``y_i``
        ``(N_i, ny)``.  ``x_init`` (nonlinear models) is one shared
        ``(nx,)`` point or per-record ``(B, nx)`` points; ``prior`` shared
        or per-record (see :meth:`stacked`).  Solved by pad-and-bucket
        (:mod:`repro_torch.core.padding`): records are padded to
        ``bucket_sizes`` (default: powers of two of ``nsub`` blocks), and
        ``pad_batch`` rounds each bucket's record count up to a power of
        two.  The solutions carry a
        :class:`~repro_torch.core.types.PaddingReport`.
        """
        records = tuple(records)
        if not records:
            raise ValueError("records must be non-empty")
        ts_all, y_all = [], []
        for i, (ts_i, y_i) in enumerate(records):
            ts_i, y_i = _tensor(ts_i), _tensor(y_i)
            if y_i.dim() != 2 or y_i.shape[0] < 1:
                raise ValueError(
                    f"record {i}: y must be (N, ny) with N >= 1, "
                    f"got {tuple(y_i.shape)}")
            if tuple(ts_i.shape) != (y_i.shape[0] + 1,):
                raise ValueError(
                    f"record {i}: ts must be (N+1,) = "
                    f"{(y_i.shape[0] + 1,)}, got {tuple(ts_i.shape)}")
            _check_ny(model, y_i, where=f"record {i}: ")
            ts_all.append(ts_i)
            y_all.append(y_i)
        if x_init is not None:
            if not isinstance(model, NonlinearSDE):
                raise ValueError(
                    "x_init is only meaningful for NonlinearSDE problems")
            x_init = _tensor(x_init)
            nx = model.nx
            if tuple(x_init.shape) not in {(nx,), (len(records), nx)}:
                raise ValueError(
                    f"ragged x_init must be ({nx},) shared or "
                    f"({len(records)}, {nx}) per-record points, "
                    f"got {tuple(x_init.shape)}")
        prior = _check_prior(model, prior, len(records))
        return cls(model, tuple(ts_all), tuple(y_all), None, x_init, prior,
                   kind="ragged",
                   bucket_sizes=None if bucket_sizes is None
                   else tuple(bucket_sizes),
                   pad_batch=pad_batch)

    @property
    def num_records(self) -> int:
        if self.kind == "single":
            return 1
        if self.kind == "stacked":
            return self.y.shape[0]
        return len(self.y)

    @property
    def lengths(self) -> Tuple[int, ...]:
        """Interval count per record."""
        if self.kind == "single":
            return (self.y.shape[0],)
        if self.kind == "stacked":
            return (self.y.shape[1],) * self.y.shape[0]
        return tuple(y_i.shape[0] for y_i in self.y)


def legacy_options(model: Model, method: str, *, nsub=None, mode=None,
                   iterations=None, divergence_correction=None):
    """Map the deprecated entry points' keyword arguments onto the
    method's options dataclass (fields a method does not declare are
    dropped, as the old dispatch ignored them)."""
    spec = get_method(method)
    inner = spec.options_cls.from_legacy(nsub=nsub, mode=mode)
    if isinstance(model, NonlinearSDE):
        outer = {k: v for k, v in
                 dict(iterations=iterations,
                      divergence_correction=divergence_correction).items()
                 if v is not None}
        return IteratedOptions(inner=inner, **outer)
    return inner


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (or left as
    the default) but unavailable: only an explicit ``"cpu"`` runs there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class Estimator:
    """MAP estimation for one model + method + options on a device or a
    mesh of devices.

    Args:
      model: :class:`LinearSDE` or :class:`NonlinearSDE`; problems passed
        to :meth:`solve` must be built with this model object.
      method: registered method name (see
        :func:`repro_torch.core.registry.method_names`), e.g.
        ``"parallel_rts"`` or ``"parallel_kernel"`` (the CUDA-kernel scan).
      options: instance of the method's options class; for nonlinear
        models either that or an :class:`IteratedOptions` wrapping it.
        ``None`` means all defaults.
      device: where the solve runs and its results land (the home
        device); ``None`` means ``"cuda"``, or the mesh's first device
        when a mesh is given (another device then raises).
      mesh: ``None``, a :class:`repro_torch.distributed.Mesh` or a
        :class:`~repro_torch.distributed.MeshSpec` (built on the distinct
        devices of ``device``'s type; build it with an explicit device
        list, which may repeat a device, for anything else).  Stacked
        records are split over ``mesh.shape[batch_axis]`` devices;
        ``method="distributed"`` also shards the time axis over the mesh
        axis its options name (an ambient ``MeshSpec.activate()`` mesh is
        used when this mesh has no such axis), and splits the records over
        the first of its ``batch_axes`` on the mesh.
      batch_axis: the mesh axis that splits the records of
        non-distributed methods.
      diagnostics: compute ``Solution.cost`` (and the iteration traces of
        nonlinear solves; default); ``False`` skips them.
      cache: a private :class:`ExecutableCache` (default: the module-level
        cache every estimator shares).  Its key holds the device and the
        fingerprint of the resolved mesh, so an entry built for one device
        or mesh is never run on another.
    """

    def __init__(self, model: Model, *, method: str = "parallel_rts",
                 options=None, device=None, mesh=None,
                 batch_axis: str = "data", diagnostics: bool = True,
                 cache: Optional[ExecutableCache] = None):
        self._spec = get_method(method)
        self.model = model
        self.method = method
        self.options = self._resolve_options(options)
        # The spec that solves each (linearised) grid problem: an iterated
        # nonlinear method delegates to its options' inner_method; every
        # other method IS the grid solver.
        self._grid_spec = (get_method(self.options.inner_method)
                           if self._spec.nonlinear else self._spec)
        self._distributed = issubclass(self._grid_spec.options_cls,
                                       DistributedOptions)
        self.mesh = as_mesh(mesh, device_type=torch.device(
            "cuda" if device is None else device).type)
        self.batch_axis = batch_axis
        if self.mesh is not None:
            home = self.mesh.devices.flat[0]
            if device is not None and canonical_device(device) != home:
                raise ValueError(
                    f"device {device!r} is not the mesh's first device "
                    f"{home}; pass device=None or that device")
            device = home
        self.device = resolve_device(device)
        self.diagnostics = diagnostics
        self._cache = _CACHE if cache is None else cache
        self._models = {}
        self._model = self._model_on(self.device)

    def _model_on(self, device: torch.device) -> Model:
        """The model's tensors on ``device`` (one copy per device)."""
        key = str(device)
        if key not in self._models:
            self._models[key] = self.model.to(device=device)
        return self._models[key]

    def _resolve_options(self, options):
        cls = self._spec.options_cls
        nonlinear_model = isinstance(self.model, NonlinearSDE)
        if self._spec.nonlinear:
            # An iterated nonlinear method: the options ARE the outer-loop
            # options; the grid solver is named by options.inner_method.
            if not nonlinear_model:
                raise TypeError(
                    f"method {self.method!r} is an iterated nonlinear "
                    f"method and needs a NonlinearSDE model, got "
                    f"{type(self.model).__name__}")
            if options is None:
                options = cls()
            elif isinstance(options, SolverOptions):
                options = cls(inner=options)
            elif not isinstance(options, cls):
                raise TypeError(
                    f"options for method {self.method!r} must be "
                    f"{cls.__name__} (or a bare inner-method SolverOptions),"
                    f" got {type(options).__name__}")
            inner_spec = get_method(options.inner_method)
            if inner_spec.nonlinear:
                raise ValueError(
                    f"inner_method {options.inner_method!r} is itself an "
                    f"iterated nonlinear method; it must name a linear grid "
                    f"solver (e.g. 'parallel_rts', 'sequential_rts')")
            inner = (options.inner if options.inner is not None
                     else inner_spec.options_cls())
            if not isinstance(inner, inner_spec.options_cls):
                raise TypeError(
                    f"{cls.__name__}.inner for inner_method "
                    f"{options.inner_method!r} must be "
                    f"{inner_spec.options_cls.__name__}, got "
                    f"{type(inner).__name__}")
            return options.replace(inner=inner)
        if nonlinear_model:
            if options is None:
                options = IteratedOptions()
            elif isinstance(options, cls):
                options = IteratedOptions(inner=options)
            elif not isinstance(options, IteratedOptions):
                raise TypeError(
                    f"options for nonlinear method {self.method!r} must be "
                    f"{cls.__name__} or IteratedOptions, got "
                    f"{type(options).__name__}")
            if type(options) is not IteratedOptions:
                raise TypeError(
                    f"{type(options).__name__} belongs to an iterated "
                    f"nonlinear method, not method={self.method!r}; use "
                    f"the method it was registered with (e.g. "
                    f"method='sigma_point') or plain IteratedOptions")
            inner = options.inner if options.inner is not None else cls()
            if not isinstance(inner, cls):
                raise TypeError(
                    f"IteratedOptions.inner for method {self.method!r} must "
                    f"be {cls.__name__}, got {type(inner).__name__}")
            return options.replace(inner=inner)
        if isinstance(options, IteratedOptions):
            raise TypeError(
                "IteratedOptions is for NonlinearSDE models; linear models "
                f"take {cls.__name__}")
        if options is None:
            options = cls()
        if not isinstance(options, cls):
            raise TypeError(
                f"options for method {self.method!r} must be "
                f"{cls.__name__}, got {type(options).__name__}")
        return options

    @property
    def block_size(self) -> int:
        """Grid-length multiple required by the method (``nsub`` for
        parallel methods, 1 otherwise) -- the bucketing unit."""
        return getattr(self._method_options(), "nsub", 1)

    # -- mesh plumbing ------------------------------------------------------

    def _method_options(self):
        """The method-level options (unwrapping ``IteratedOptions``)."""
        o = self.options
        return o.inner if isinstance(o, IteratedOptions) else o

    def _resolved_mesh(self):
        """The mesh this solve runs under, resolved once per solve and
        handed to the solver: ``self.mesh`` for every method but
        ``distributed``, which takes ``self.mesh`` if it has the time axis,
        else the ambient ``MeshSpec.activate()`` one, else a default
        time-only mesh (``None`` = the single-device fallback)."""
        if not self._distributed:
            return self.mesh
        o = self._method_options()
        return resolve_time_mesh(o.time_axis,
                                 devices_per_time=o.devices_per_time,
                                 mesh=self.mesh,
                                 device_type=self.device.type)

    def _batch_spmd_axis(self, mesh) -> Optional[str]:
        """The mesh axis a stacked batch is split over: ``batch_axis`` for
        most methods; for ``distributed`` the first of its options'
        ``batch_axes`` on the mesh (so the same options serve time-only
        and 2-D meshes)."""
        if mesh is None:
            return None
        if not self._distributed:
            return self.batch_axis if self.batch_axis in mesh.axis_names \
                else None
        o = self._method_options()
        for a in o.batch_axes:
            if a in mesh.axis_names and a != o.time_axis:
                return a
        return None

    def _batch_shard_size(self, mesh) -> int:
        """Devices the stacked record axis spreads over (1 = unsharded)."""
        axis = self._batch_spmd_axis(mesh)
        return 1 if axis is None else mesh.shape[axis]

    def _synchronize(self, mesh) -> None:
        devices = {self.device}
        if mesh is not None:
            devices.update(mesh.devices.flat)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def solve(self, problem: Problem):
        """Solve a :class:`Problem`.

        Returns a :class:`~repro_torch.core.types.Solution` (single and
        stacked layouts; stacked solutions carry the record axis first,
        ``x`` ``(B, N+1, nx)``, ``cost_trace`` ``(B, iterations)``) or,
        for a ragged problem, a list of per-record ``Solution``\\ s in
        submission order, each carrying the shared
        :class:`~repro_torch.core.types.PaddingReport`.

        While :mod:`repro_torch.obs` is enabled (and ``diagnostics`` is on
        -- the hot-serving opt-out also silences instrumentation) the
        solve is measured: phase spans ``estimator.solve.{prepare,compile,
        execute,host_transfer}`` (``compile`` for a new cache entry,
        ``execute`` for a cached one; both ended by a device synchronise on
        the card, so they time real work), the ``cache.compile_seconds``
        histogram of new entries and the ``estimator.*``, ``nonlinear.*``
        and ``linearize.*`` metrics.  Either way, while a
        ``torch.profiler`` records, the solve is an ``estimator.solve``
        range on its timeline, with ``solve.*`` ranges at each layer
        inside (``repro_torch.obs.tracing``).  Outputs are bit-identical
        either way.
        """
        self._check_model(problem)
        if problem.kind == "ragged":
            return self._solve_ragged(problem)
        if not (self.diagnostics and obs.enabled()):
            # hot path: no obs object touched, nothing synchronised
            with trace_range("estimator.solve"):
                fn, args, _, _ = self._prepare(problem)
                return fn(*args)
        with obs.trace_span("estimator.solve"):
            with obs.trace_span("estimator.solve.prepare"):
                fn, args, fresh, mesh = self._prepare(problem)
            phase = ("estimator.solve.compile" if fresh
                     else "estimator.solve.execute")
            t0 = time.perf_counter()
            with obs.trace_span(phase):
                out = fn(*args)
                self._synchronize(mesh)
            if fresh:
                obs.record("cache.compile_seconds", time.perf_counter() - t0)
            with obs.trace_span("estimator.solve.host_transfer"):
                self._record_solution_metrics(out)
        return out

    def lower(self, problem: Problem) -> Lowered:
        """Ahead-of-time path: the :class:`Lowered` solve of this problem's
        layout (``.compile()`` it, then call the :class:`Compiled` entry
        with the problem's arrays).  A ragged problem is one stacked solve
        per bucket and cannot be lowered as one -- lower the buckets'
        stacked problems instead."""
        if problem.kind == "ragged":
            raise ValueError(
                "lower() supports single/stacked problems; a ragged solve "
                "composes one executable per bucket")
        self._check_model(problem)
        with obs.trace_span("estimator.lower"):
            fn, _, _, _ = self._prepare(problem)
            return Lowered(fn)

    def _check_model(self, problem: Problem) -> None:
        if problem.model is not self.model:
            raise ValueError(
                "problem.model is not this Estimator's model object; build "
                "the Problem with the same model instance (solves are "
                "cached per model object)")

    def _prepare(self, problem: Problem):
        """``(entry, args, fresh, mesh)``: the cached :class:`Compiled`
        solve of this problem's layout on the mesh resolved now (built on
        a miss, ``fresh``), the problem's arrays in the entry's argument
        order, and that mesh."""
        mesh = self._resolved_mesh()
        stacked = problem.kind == "stacked"
        shards = self._batch_shard_size(mesh) if stacked else 1
        if shards > 1 and problem.y.shape[0] % shards:
            raise ValueError(
                f"batch {problem.y.shape[0]} not divisible by mesh batch "
                f"axis size {shards}")
        args = [problem.ts, problem.y]
        has = (problem.measurement_mask is not None,
               problem.x_init is not None, problem.prior is not None)
        if has[0]:
            args.append(problem.measurement_mask)
        if has[1]:
            args.append(problem.x_init)
        if has[2]:
            args.extend(problem.prior)
        signature = _signature(args)
        # the resolved mesh's fingerprint: an entry built for one mesh is
        # never run on another, even when the mesh arrives ambiently
        key_tail = (self.method, self.options, problem.kind, self.batch_axis,
                    mesh_fingerprint(mesh), *has, self.diagnostics,
                    signature, _device_key(self.device))

        def build():
            # the entry runs a copy of the estimator that holds no cache: an
            # estimator and its private cache would form a reference cycle
            # (estimator -> cache -> entry -> estimator), and its tensors
            # would wait for the garbage collector
            solver = copy.copy(self)
            solver._cache = None
            run = functools.partial(solver._run, problem.kind, has, shards,
                                    mesh)
            kernel = self.device.type == "cuda" and isinstance(
                self._method_options(), KernelOptions)
            return Compiled(run, signature, _scan_library if kernel else None)

        fn, fresh = self._cache.get_entry(self.model, self.mesh, key_tail,
                                          build)
        return fn, args, fresh, mesh

    def _run(self, kind: str, has: tuple, shards: int, mesh, *args):
        """Solve one entry's arguments: move them to the estimator's device
        and dtype, lay them out with the record axis right after the time
        axis (a single record is a batch of one) and run :meth:`_execute`,
        split over the mesh's batch axis when ``shards > 1``."""
        dtype = self._model.dtype
        it = iter(a.to(device=self.device, dtype=dtype) for a in args)
        ts, y = next(it), next(it)
        mask = next(it) if has[0] else None
        x_init = next(it) if has[1] else None
        prior = (next(it), next(it)) if has[2] else None
        single = kind == "single"
        if single:
            ts, y = ts[:, None], y[:, None]
            mask = None if mask is None else mask[:, None]
            if x_init is not None and x_init.dim() == 2:
                x_init = x_init[:, None]                  # (N+1, 1, nx)
        else:
            B = y.shape[0]
            y = y.movedim(0, 1)
            ts = ts.T if ts.dim() == 2 else ts[:, None].expand(-1, B)
            mask = None if mask is None else mask.T
            if x_init is not None:
                x_init = self._stacked_x_init(x_init, B)
        args = (single, ts, y, mask, x_init, prior)
        if shards == 1:
            return self._execute(*args, mesh=mesh)
        # the record dim of each argument (None: shared by every shard)
        per_xi = x_init is not None and x_init.dim() == 3 and (
            x_init.shape[1] == B)
        per_prior = prior is not None and prior[0].dim() == 3
        in_axes = (None, 1, 1, 1, 1 if per_xi else None,
                   0 if per_prior else None)
        return shard_over_batch(self._execute, mesh,
                                self._batch_spmd_axis(mesh), in_axes)(*args)

    def _execute(self, single, ts, y, mask, x_init, prior, *,
                 mesh) -> Solution:
        """Run the method on prepared tensors (on their device) and, for
        ``distributed``, on ``mesh``; returns the surface
        :class:`Solution`."""
        trace = steps = None
        model = self._model_on(y.device)
        solve_grid = self._grid_spec.solver
        if self._distributed:
            solve_grid = functools.partial(solve_grid, mesh=mesh)
        if isinstance(self.model, NonlinearSDE):
            o = self.options
            sol, trace, steps = iterated_solve(
                model, ts, y,
                lambda grid: solve_grid(grid, o.inner),
                iterations=o.iterations,
                divergence_correction=o.divergence_correction,
                x_init=x_init, measurement_mask=mask, prior=prior,
                track_costs=self.diagnostics,
                linearization=o.linearization)
            cost = None if trace is None else trace[-1]
        else:
            with trace_range("solve.grid"):
                grid = grid_lqt_from_linear(model, ts, y,
                                            measurement_mask=mask,
                                            prior=prior)
            sol = solve_grid(grid, self.options)
            cost = None
            if self.diagnostics:
                with trace_range("solve.cost"):
                    cost = om_cost_grid(grid, sol.x)

        def surface(a):
            if a is None:
                return None
            a = a.movedim(1, 0).contiguous()              # (R, N+1, ...)
            return a[0] if single else a

        def per_record(a):                 # (*R) or (iterations, *R)
            if a is None:
                return None
            a = a.movedim(0, -1) if a.dim() == 2 else a
            return a[0] if single else a

        return Solution(
            x=surface(sol.x), S=surface(sol.S), v=surface(sol.v),
            cov=surface(sol.cov), cost=per_record(cost),
            cost_trace=per_record(trace), step_norms=per_record(steps))

    def _record_solution_metrics(self, sol: Solution) -> None:
        """Read one solve's diagnostics into the registry (the measured
        path only: each value is one device-to-host read)."""
        obs.inc("estimator.solves")
        if isinstance(self.options, IteratedOptions):
            lin = self.options.linearization
            obs.inc(f"linearize.{lin.obs_name}.solves")
            obs.set_gauge("linearize.sigma_points",
                          lin.num_points(self.model.nx))
        if sol.cost is not None:
            obs.record("estimator.final_cost", sol.cost.mean())
        if sol.cost_trace is not None:
            trace = sol.cost_trace
            obs.set_gauge("nonlinear.iterations", trace.shape[-1])
            obs.record("nonlinear.cost_decrease",
                       (trace[..., 0] - trace[..., -1]).mean())
        if sol.step_norms is not None:
            obs.record("nonlinear.final_step_norm",
                       sol.step_norms[..., -1].mean())

    def _solve_ragged(self, problem: Problem) -> List[Solution]:
        """Pad-and-bucket: one stacked solve per bucket of records padded
        to one length, its batch rounded up to a power of two (with
        ``pad_batch``) and then to a multiple of the mesh's batch axis, by
        recycling the bucket's first record.  Each bucket shape is one
        cache entry, so a repeated shape is a hit."""
        lengths = problem.lengths
        buckets: Dict[int, List[int]] = {}
        for i, N_i in enumerate(lengths):
            n_pad = bucket_length(N_i, self.block_size, problem.bucket_sizes)
            buckets.setdefault(n_pad, []).append(i)

        x_init, prior = problem.x_init, problem.prior
        per_record_xi = x_init is not None and x_init.dim() == 2
        per_record_prior = prior is not None and prior[0].dim() == 3

        out: List[Optional[Solution]] = [None] * len(lengths)
        infos: List[BucketInfo] = []
        axis = self._batch_shard_size(self._resolved_mesh())
        for n_pad, idxs in sorted(buckets.items()):
            B = len(idxs)
            B_pad = next_pow2(B) if problem.pad_batch else B
            if axis > 1:
                B_pad = -(-B_pad // axis) * axis
            rows = idxs + [idxs[0]] * (B_pad - B)           # recycle row 0
            padded = {i: pad_record(problem.ts[i], problem.y[i], n_pad)
                      for i in idxs}
            ts_b, ys_b, mask_b = (torch.stack([padded[i][j] for i in rows])
                                  for j in range(3))
            xi_b = x_init[rows] if per_record_xi else x_init
            pr_b = (tuple(a[rows] for a in prior) if per_record_prior
                    else prior)
            sub = Problem.stacked(self.model, ts_b, ys_b,
                                  measurement_mask=mask_b, x_init=xi_b,
                                  prior=pr_b)
            sol = self.solve(sub)
            infos.append(BucketInfo(n_pad=n_pad, records=B, batch=B_pad))
            for row, i in enumerate(idxs):
                out[i] = slice_solution(sol, row, lengths[i])

        report = PaddingReport(lengths=tuple(lengths), buckets=tuple(infos))
        if self.diagnostics and obs.enabled():
            obs.inc("padding.records", report.records)
            obs.inc("padding.real_intervals", report.real_intervals)
            obs.inc("padding.solved_intervals", report.solved_intervals)
            obs.set_gauge("padding.interval_utilisation",
                          report.interval_utilisation)
            obs.set_gauge("padding.row_utilisation", report.row_utilisation)
            obs.set_gauge("padding.waste", 1.0 - report.interval_utilisation)
        return [dataclasses.replace(s, padding=report) for s in out]

    @staticmethod
    def _stacked_x_init(x_init: torch.Tensor, B: int) -> torch.Tensor:
        """A stacked problem's warm start in the port's layout: ``(nx,)``
        stays, a shared ``(N+1, nx)`` gains a record dim, per-record
        ``(B, nx)`` points and ``(B, N+1, nx)`` trajectories move their
        record axis after time.  In the ambiguous ``B == N+1`` rank-2 case
        the per-record reading wins."""
        if x_init.dim() == 1:
            return x_init
        if x_init.dim() == 2 and x_init.shape[0] != B:
            return x_init[:, None]
        if x_init.dim() == 2:
            return x_init[None]                           # (1, B, nx)
        return x_init.movedim(0, 1)
