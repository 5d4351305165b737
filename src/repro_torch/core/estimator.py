"""The estimation surface: ``Estimator.solve(Problem) -> Solution``.

* :class:`Problem` describes WHAT to solve -- model + time grid +
  measurements (+ optional mask / information-form prior), as one record
  (:meth:`Problem.single`) or records sharing a length
  (:meth:`Problem.stacked`).  The constructors validate shapes up front.
* :class:`~repro_torch.core.options.SolverOptions` subclasses describe HOW;
  each registered method owns its options dataclass.
* :class:`Estimator` binds (model, method, options, device).  ``device``
  defaults to ``"cuda"``; without a card it raises unless the caller asks
  for ``device="cpu"``.
* :class:`~repro_torch.core.types.Solution` is the result, with the
  Onsager-Machlup cost of the estimate.

Records are solved together: the record batch rides as a tensor dim right
after the time axis through every stage (a single problem is a batch of
one), so each scan level is one batched operation -- one kernel launch for
``parallel_kernel`` -- over all records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .registry import get_method
from .sde import LinearSDE, grid_lqt_from_linear, om_cost_grid
from .types import Solution


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.array(a))


def _check_ny(model: LinearSDE, y) -> None:
    """Reject measurements whose trailing dimension does not match the
    model's ``ny``: a mismatched ``y`` would otherwise broadcast silently
    against ``H x`` (skipped when ``R`` is a callable)."""
    ny = model.ny
    if ny is not None and y.shape[-1] != ny:
        raise ValueError(
            f"y has measurement dimension {y.shape[-1]} but the model's R "
            f"is {ny}x{ny} (ny={ny})")


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


def _check_prior(model: LinearSDE, prior, batch: Optional[int]):
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


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """One estimation workload: model + data (+ optional mask / prior).

    Build via :meth:`single` or :meth:`stacked`; arrays may be tensors or
    anything ``numpy.array`` takes.  They are moved to the estimator's
    device and the model's dtype at solve time.
    """

    model: LinearSDE
    ts: Any
    y: Any
    measurement_mask: Optional[torch.Tensor] = None
    prior: Any = None
    kind: str = "single"

    @classmethod
    def single(cls, model: LinearSDE, ts, y, *, measurement_mask=None,
               prior=None) -> "Problem":
        """One record: ``ts`` ``(N+1,)``, ``y`` ``(N, ny)``; ``prior``
        ``(S0, v0)`` is an information-form initial boundary replacing the
        model's ``(m0, P0)``."""
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
        prior = _check_prior(model, prior, None)
        return cls(model, ts, y, measurement_mask, prior, kind="single")

    @classmethod
    def stacked(cls, model: LinearSDE, ts, ys, *, measurement_mask=None,
                prior=None) -> "Problem":
        """Stacked records ``ys`` ``(B, N, ny)`` sharing the interval
        count; ``ts`` shared ``(N+1,)`` or per-record ``(B, N+1)``;
        ``prior`` shared or per-record (see :meth:`single`)."""
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
        prior = _check_prior(model, prior, B)
        return cls(model, ts, ys, measurement_mask, prior, kind="stacked")

    @property
    def num_records(self) -> int:
        return 1 if self.kind == "single" else self.y.shape[0]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (or left as
    the default) but unavailable: only an explicit ``"cpu"`` runs there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class Estimator:
    """MAP estimation for one model + method + options on one device.

    Args:
      model: :class:`LinearSDE`; problems passed to :meth:`solve` must be
        built with this model object.
      method: registered method name (see
        :func:`repro_torch.core.registry.method_names`), e.g.
        ``"parallel_rts"`` or ``"parallel_kernel"`` (the CUDA-kernel scan).
      options: instance of the method's options class; ``None`` means all
        defaults.
      device: where the solve runs; ``None`` means ``"cuda"``.
      diagnostics: compute ``Solution.cost`` (default); ``False`` skips it.
    """

    def __init__(self, model: LinearSDE, *, method: str = "parallel_rts",
                 options=None, device=None, diagnostics: bool = True):
        self._spec = get_method(method)
        self.model = model
        self.method = method
        cls = self._spec.options_cls
        if options is None:
            options = cls()
        if not isinstance(options, cls):
            raise TypeError(
                f"options for method {method!r} must be {cls.__name__}, "
                f"got {type(options).__name__}")
        self.options = options
        self.device = resolve_device(device)
        self.diagnostics = diagnostics
        self._model = model.to(device=self.device)

    def solve(self, problem: Problem) -> Solution:
        """Solve a :class:`Problem`; stacked solutions carry the record
        axis first (``x`` ``(B, N+1, nx)``)."""
        if problem.model is not self.model:
            raise ValueError(
                "problem.model is not this Estimator's model object; build "
                "the Problem with the same model instance")
        dtype = self._model.dtype

        def put(a):
            return None if a is None else a.to(device=self.device,
                                                dtype=dtype)

        ts, y, mask = put(problem.ts), put(problem.y), put(
            problem.measurement_mask)
        prior = None if problem.prior is None else tuple(
            put(a) for a in problem.prior)
        # Record axis right after the time axis; a single record is a
        # batch of one.
        if problem.kind == "single":
            ts, y = ts[:, None], y[:, None]
            mask = None if mask is None else mask[:, None]
        else:
            B = y.shape[0]
            y = y.movedim(0, 1)
            ts = ts.T if ts.dim() == 2 else ts[:, None].expand(-1, B)
            mask = None if mask is None else mask.T
        grid = grid_lqt_from_linear(self._model, ts, y,
                                    measurement_mask=mask, prior=prior)
        sol = self._spec.solver(grid, self.options)
        cost = om_cost_grid(grid, sol.x) if self.diagnostics else None

        def surface(a):
            a = a.movedim(1, 0).contiguous()              # (R, N+1, ...)
            return a[0] if problem.kind == "single" else a

        return Solution(
            x=surface(sol.x), S=surface(sol.S), v=surface(sol.v),
            cost=None if cost is None else (
                cost[0] if problem.kind == "single" else cost))
