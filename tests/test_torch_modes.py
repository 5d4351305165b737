"""The paper's ODE element modes (``euler``/``rk4``), the two-filter
smoother and the QP oracle of the PyTorch port, held against the JAX
reference at float64.

Both packages get the same grids: the reference builds them from its Wiener
velocity and random time-varying test models (plus a seeded numpy linear
cost ``lin`` and mask, so every term of eqs. 15/43/51 is exercised) and the
port receives them as numpy arrays.  The grids are short (N = 24 at
dt = 0.05), where the reference's explicit Euler is finite.

Tolerances: rtol 1e-10 for the ODE modes (the same steps in the same
order); 1e-9 for the QP oracle and for the two-filter smoother's default
fills (``block0_fill="affine"``, ``tf_fill="combine"``).  Two other paths
of the two-filter smoother are ill-conditioned by construction, so two
LAPACKs agree there only to about cond x eps:
``block0_fill="min_initial"`` and ``sequential_two_filter`` fold the
jitter-regularised eq. (50) at single substeps, where
``J0 + 1e-9 trace(J0)/nx I`` has a condition number near 1e9, and
``tf_fill="hjb_euler"`` integrates the stiff forward HJB (C grows to ~1e9
on the LTV grid).  Measured port-vs-reference gaps there reach 2.4e-6;
they are held to 1e-5, the reference's own tolerance for two-filter
results (``tests/test_nonlinear.py::test_two_filter_ieks``).  The
``min_initial`` fold needs J0 invertible: on a grid whose first substep is
masked (J0 = 0) the reference returns non-finite values and the port
raises, which a test pins.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_ltv, wiener_velocity
from repro.core import clear_cache as jclear_cache
from repro.core import Estimator as JEstimator
from repro.core import Problem as JProblem
from repro.core import SequentialOptions as JSequentialOptions
from repro.core import TwoFilterOptions as JTwoFilterOptions
from repro.core import combine as jcombine
from repro.core import elements as jelements
from repro.core import oracle as joracle
from repro.core import parallel as jparallel
from repro.core import sde as jsde
from repro.core import sequential as jsequential
from repro.core.types import LQTElement as JElem
from repro.core.types import ValueFn as JValue
from repro_torch.convert import (
    elements_from_numpy,
    grid_from_numpy,
    linear_sde_from_numpy,
)
from repro_torch.core import (
    Estimator,
    Problem,
    SequentialOptions,
    TwoFilterOptions,
    method_names,
)
from repro_torch.core import combine as tcombine
from repro_torch.core import elements as telements
from repro_torch.core import oracle as toracle
from repro_torch.core import parallel as tparallel
from repro_torch.core import sequential as tsequential
from repro_torch.core.types import ValueFn

torch.set_num_threads(1)

ODE_RTOL = 1e-10
TF_RTOL = 1e-9
TF_ILL_RTOL = 1e-5       # jitter-regularised folds and the stiff HJB fill
NSUB = 4
N = 24
MODES = ("euler", "rk4")


def _close(got, want, rtol, atol=1e-12):
    """Field-wise comparison of a port tuple/tensor with a JAX one; NaNs
    must sit in the same places."""
    if want is None:
        assert got is None
        return
    if isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol, equal_nan=True)
        return
    assert len(tuple(got)) == len(tuple(want))
    for g, w in zip(tuple(got), tuple(want)):
        _close(g, w, rtol, atol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _psd(rng, B, n):
    A = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", A, A) / n + 0.1 * np.eye(n)


def _sde_arrays(model):
    return {k: np.asarray(getattr(model, k))
            for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")}


@pytest.fixture(scope="module")
def grids():
    """name -> (reference grid, port grid): Wiener velocity and the random
    LTV model (with a seeded linear cost term), each with a seeded
    measurement mask and, as ``<name>_full``, without one."""
    rng = np.random.default_rng(5)
    ts = jsde.time_grid(0.0, 1.2, N)
    mask = jnp.asarray((rng.random(N) > 0.3).astype(np.float64))
    out = {}
    for name, model in (("wiener", wiener_velocity()),
                        ("ltv", random_ltv(jax.random.PRNGKey(7)))):
        y = jnp.asarray(5.0 + rng.standard_normal((N, 2)))
        lin = jnp.asarray(0.1 * rng.standard_normal((N, model.nx)))
        for key, m in ((name, mask), (name + "_full", None)):
            jg = jsde.grid_lqt_from_linear(model, ts, y, measurement_mask=m)
            if name == "ltv":
                jg = jg._replace(lin=lin)
            tg = grid_from_numpy({k: None if v is None else np.asarray(v)
                                  for k, v in jg._asdict().items()})
            out[key] = (jg, tg)
    return out


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


# ---------------------------------------------------------------------------
# elements and fills
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wiener", "ltv"])
@pytest.mark.parametrize("integrator", MODES)
def test_euler_block_elements_match_reference(grids, name, integrator):
    jg, tg = grids[name]
    want = _jit(jelements.euler_block_elements, nsub=NSUB,
                integrator=integrator)(jg)
    got = telements.euler_block_elements(tg, NSUB, integrator=integrator)
    assert got.A.shape == (N // NSUB, jg.nx, jg.nx)
    _close(got, want, ODE_RTOL)


@pytest.mark.parametrize("name", ["wiener", "ltv"])
def test_value_fills_match_reference(grids, name):
    jg, tg = grids[name]
    rng = np.random.default_rng(8)
    T, nx = N // NSUB, jg.nx
    S, v = _psd(rng, T, nx), rng.standard_normal((T, nx))
    for integrator in MODES:
        want = _jit(jelements.backward_value_fill_euler, nsub=NSUB,
                    integrator=integrator)(jg, boundary=JValue(S, v))
        got = telements.backward_value_fill_euler(
            tg, NSUB, ValueFn(_t(S), _t(v)), integrator=integrator)
        _close(got, want, ODE_RTOL)
    left = (rng.standard_normal((T, nx, nx)) * 0.5,
            rng.standard_normal((T, nx)), _psd(rng, T, nx),
            rng.standard_normal((T, nx)), _psd(rng, T, nx))
    want = _jit(jelements.forward_value_fill_euler, nsub=NSUB)(
        jg, left=JElem(*map(jnp.asarray, left)))
    got = telements.forward_value_fill_euler(tg, NSUB,
                                             elements_from_numpy(left))
    _close(got, want, ODE_RTOL)
    _, jsub = jelements.discrete_block_elements(jg, NSUB)
    _, tsub = telements.discrete_block_elements(tg, NSUB)
    want = jax.jit(jelements.forward_value_fill_discrete)(
        jsub, JElem(*map(jnp.asarray, left)))
    _close(telements.forward_value_fill_discrete(
        tsub, elements_from_numpy(left)), want, ODE_RTOL)


@pytest.mark.parametrize("jitter", [0.0, 1e-9])
def test_elem_min_initial_matches_reference(jitter):
    rng = np.random.default_rng(4)
    arrs = (rng.standard_normal((6, 3, 3)) * 0.6, rng.standard_normal((6, 3)),
            _psd(rng, 6, 3), rng.standard_normal((6, 3)), _psd(rng, 6, 3))
    want = jax.vmap(lambda e: jcombine.elem_min_initial(e, jitter=jitter))(
        JElem(*map(jnp.asarray, arrs)))
    got = tcombine.elem_min_initial(elements_from_numpy(arrs), jitter=jitter)
    _close(got, want, ODE_RTOL)


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wiener", "ltv"])
@pytest.mark.parametrize("mode", MODES)
def test_ode_mode_smoothers_match_reference(grids, name, mode):
    jg, tg = grids[name]
    _close(tsequential.sequential_rts(tg, mode),
           _jit(jsequential.sequential_rts, mode=mode)(jg), ODE_RTOL)
    jvals, jbnd, jblocks, _ = _jit(jparallel.parallel_backward, nsub=NSUB,
                                   mode=mode)(jg)
    tvals, tbnd, tblocks, tsub = tparallel.parallel_backward(tg, NSUB, mode)
    assert tsub is None
    _close((tvals, tbnd, tblocks), (jvals, jbnd, jblocks), ODE_RTOL)
    _close(tparallel.parallel_rts(tg, NSUB, mode),
           _jit(jparallel.parallel_rts, nsub=NSUB, mode=mode)(jg), ODE_RTOL)


@pytest.mark.parametrize("name,mode,block0_fill,tf_fill", [
    ("wiener", "euler", "affine", "combine"),
    ("ltv", "euler", "affine", "combine"),
    ("ltv", "euler", "affine", "hjb_euler"),
    ("wiener", "euler", "min_initial", "combine"),
    ("ltv", "euler", "min_initial", "hjb_euler"),
    ("ltv", "rk4", "affine", "combine"),
    ("wiener", "rk4", "min_initial", "hjb_euler"),
    ("wiener", "discrete", "affine", "combine"),
    ("ltv", "discrete", "min_initial", "combine"),
])
def test_parallel_two_filter_matches_reference(grids, name, mode,
                                               block0_fill, tf_fill):
    well_conditioned = block0_fill == "affine" and tf_fill == "combine"
    # the min_initial fold needs J0 invertible at block 0's first
    # substep, which a masked first substep does not give
    jg, tg = grids[name if block0_fill == "affine" else name + "_full"]
    want = _jit(jparallel.parallel_two_filter, nsub=NSUB, mode=mode,
                block0_fill=block0_fill, tf_fill=tf_fill)(jg)
    got = tparallel.parallel_two_filter(tg, NSUB, mode,
                                        block0_fill=block0_fill,
                                        tf_fill=tf_fill)
    _close(got, want, TF_RTOL if well_conditioned else TF_ILL_RTOL,
           atol=1e-10)
    # block 0's interior covariances are NaN exactly for "affine"
    nan_rows = torch.isnan(got.cov).flatten(1).any(-1)
    np.testing.assert_array_equal(
        nan_rows.numpy(), np.isnan(np.asarray(want.cov)).reshape(
            N + 1, -1).any(-1))
    assert bool(nan_rows.any()) == (block0_fill == "affine")


@pytest.mark.parametrize("name", ["wiener_full", "ltv_full"])
@pytest.mark.parametrize("mode", ["euler", "discrete"])
def test_sequential_two_filter_matches_reference(grids, name, mode):
    jg, tg = grids[name]
    want = _jit(jsequential.sequential_two_filter, mode=mode)(jg)
    _close(tsequential.sequential_two_filter(tg, mode), want, TF_ILL_RTOL,
           atol=1e-10)


def test_min_initial_fold_of_a_masked_substep_raises(grids):
    """J0 = 0 at a masked first substep: the reference's solve returns
    non-finite values, the port's raises instead of returning them."""
    jg, tg = grids["wiener"]
    assert float(jg.Rinv[0].sum()) == 0.0           # first substep masked
    want = _jit(jsequential.sequential_two_filter, mode="discrete")(jg)
    assert not bool(np.isfinite(np.asarray(want.x)).all())
    for call in (lambda: tsequential.sequential_two_filter(tg, "discrete"),
                 lambda: tparallel.parallel_two_filter(
                     tg, NSUB, "euler", block0_fill="min_initial")):
        with pytest.raises(torch.linalg.LinAlgError, match="singular"):
            call()


def test_two_filter_rejects_unknown_fills(grids):
    _, tg = grids["wiener"]
    with pytest.raises(ValueError, match="unknown block0_fill"):
        tparallel.parallel_two_filter(tg, NSUB, "euler", block0_fill="x")
    with pytest.raises(ValueError, match="unknown tf_fill"):
        tparallel.parallel_two_filter(tg, NSUB, "euler", tf_fill="x")


@pytest.mark.parametrize("name", ["wiener_full", "ltv_full"])
def test_qp_oracle_matches_reference(grids, name):
    """(The oracle recovers R from R^{-1}, so it takes unmasked grids.)"""
    jg, tg = grids[name]
    want = joracle.qp_map_from_grid(jg)
    got = toracle.qp_map_from_grid(tg)
    assert got.dtype == torch.float64 and got.shape == (N + 1, jg.nx)
    _close(got, want, TF_RTOL, atol=1e-10)
    # the discrete-mode smoothers solve this QP exactly
    _close(tparallel.parallel_rts(tg, NSUB, "discrete").x, want, 1e-8,
           atol=1e-8)


def test_qp_map_estimate_matches_reference():
    model = wiener_velocity()
    ts = jsde.time_grid(0.0, 1.2, N)
    y = jnp.asarray(5.0 + np.random.default_rng(2).standard_normal((N, 2)))
    want = joracle.qp_map_estimate(model, ts, y)
    got = toracle.qp_map_estimate(
        linear_sde_from_numpy(_sde_arrays(model)), _t(ts), _t(y))
    _close(got, want, TF_RTOL, atol=1e-10)


# ---------------------------------------------------------------------------
# the estimation surface in the ODE modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wiener_problem():
    """The reference's Wiener model and the port's, N = 30 (three blocks
    of the default nsub = 10) at dt = 0.05, three seeded records."""
    model = wiener_velocity()
    n = 30
    ts = jsde.time_grid(0.0, 1.5, n)
    _, y = jsde.simulate_linear(model, ts, jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    ys = np.asarray(y)[None] + 0.1 * rng.standard_normal((3, n, 2))
    return model, linear_sde_from_numpy(_sde_arrays(model)), np.asarray(ts), ys


def test_default_estimator_solves_euler_mode(wiener_problem):
    """``Estimator(model)`` with default options (``mode="euler"``) solves
    and returns the reference's answer, single and stacked."""
    jmodel, tmodel, ts, ys = wiener_problem
    est = Estimator(tmodel, device="cpu")
    assert est.options.mode == "euler"
    jest = JEstimator(jmodel)
    for jp, tp in ((JProblem.single(jmodel, ts, ys[0]),
                    Problem.single(tmodel, ts, ys[0])),
                   (JProblem.stacked(jmodel, ts, ys),
                    Problem.stacked(tmodel, ts, ys))):
        want, got = jest.solve(jp), est.solve(tp)
        for f in ("x", "S", "v", "cost"):
            _close(getattr(got, f), getattr(want, f), ODE_RTOL, atol=1e-10)


@pytest.mark.parametrize("method,mode", [
    ("parallel_two_filter", "rk4"),
    ("sequential_two_filter", "discrete"),
    ("sequential_rts", "rk4"),
])
def test_estimator_methods_in_each_mode(wiener_problem, method, mode):
    """Stacked records through the estimation surface: the smoothing
    covariances of the two-filter methods come out per record too."""
    jmodel, tmodel, ts, ys = wiener_problem
    jopts, topts, rtol = {
        "parallel_two_filter": (JTwoFilterOptions(mode=mode),
                                TwoFilterOptions(mode=mode), TF_RTOL),
        "sequential_two_filter": (JSequentialOptions(mode=mode),
                                  SequentialOptions(mode=mode), TF_ILL_RTOL),
        "sequential_rts": (JSequentialOptions(mode=mode),
                           SequentialOptions(mode=mode), ODE_RTOL),
    }[method]
    want = JEstimator(jmodel, method=method, options=jopts).solve(
        JProblem.stacked(jmodel, ts, ys))
    got = Estimator(tmodel, method=method, options=topts,
                    device="cpu").solve(Problem.stacked(tmodel, ts, ys))
    for f in ("x", "S", "v", "cov", "cost"):
        _close(getattr(got, f), getattr(want, f), rtol, atol=1e-10)


def test_two_filter_options_and_registry():
    assert set(method_names()) >= {"parallel_two_filter",
                                   "sequential_two_filter"}
    for bad in (dict(block0_fill="x"), dict(tf_fill="x"), dict(nsub=0),
                dict(mode="bogus")):
        with pytest.raises(ValueError):
            TwoFilterOptions(**bad)
        with pytest.raises(ValueError):
            JTwoFilterOptions(**bad)
    assert TwoFilterOptions() == TwoFilterOptions(
        nsub=10, mode="euler", block0_fill="affine", tf_fill="combine",
        jitter=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
