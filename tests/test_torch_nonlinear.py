"""The paper's nonlinear path in the PyTorch port: the iterated Taylor
smoother (IEKS) on the coordinated-turn model (section 5.2, Fig. 2), held
against the JAX reference's ``Estimator`` at float64.

Both packages solve the same problem: the reference's coordinated-turn
model (its ``Q``, ``R``, ``m0``, ``P0`` carried across as numpy arrays,
``f``/``h`` the port's own torch functions) and the reference's simulated
measurements, N = 200 (T = 20 blocks x nsub = 10), 3 iterations.  ``x``,
``cost_trace`` and ``step_norms`` agree at rtol 1e-8.  The port's
``parallel_kernel`` runs on the CPU through the kernel's plain version and
is held against the reference's ``parallel_rts``: the reference's own
kernel path runs the Pallas interpreter on the CPU, about 90 s per solve
at this size, and ``tests/test_torch_kernel.py`` already holds the
kernel's plain version against it.  Warm starts are compared with the
reference's outputs directly (not with ``test_x_init_warm_start``'s drift
bound, which fails in the reference).
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import coordinated_turn
from repro.core import clear_cache as jclear_cache
from repro.configs.coordinated_turn import CoordinatedTurnConfig as JCTConfig
from repro.core import Estimator as JEstimator
from repro.core import IteratedOptions as JIteratedOptions
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import SequentialOptions as JSequentialOptions
from repro.core import TwoFilterOptions as JTwoFilterOptions
from repro.core import sde as jsde
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro.linearize import Taylor as JTaylor
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import nonlinear_sde_from_numpy
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    LinearSDE,
    ParallelOptions,
    Problem,
    SequentialOptions,
    TwoFilterOptions,
    grid_lqt_from_nonlinear,
    om_cost_nonlinear,
    simulate_nonlinear,
)
from repro_torch.core import registry
from repro_torch.linearize import (
    SLR,
    Cubature,
    GaussHermite,
    Taylor,
    Unscented,
    get_linearization,
)

torch.set_num_threads(1)

# torch's forward-mode AD (``torch.func.jacfwd``) loads its decompositions
# through ``torch.jit.script`` on first use, which this torch build marks
# deprecated: a third-party deprecation, not the port's.
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

RTOL = 1e-8
N, NSUB, ITERS, B = 200, 10, 3, 3


def _t(a):
    return torch.as_tensor(np.array(a))


def _linear():
    """A linear model of the coordinated turn's sizes (nx = 5, ny = 2)."""
    z = torch.zeros
    return LinearSDE(F=torch.eye(5), c=z(5), H=z(2, 5), r=z(2),
                     Q=torch.eye(5), R=torch.eye(2), m0=z(5), P0=torch.eye(5))


def _port_model(jmodel):
    cfg = CoordinatedTurnConfig()
    ref = cfg.model()
    return nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)


@pytest.fixture(scope="module")
def ct():
    """The reference's model, measurements and three perturbed records,
    the port's model, and a memo of reference solves."""
    jmodel = coordinated_turn()
    ts = time_grid(0.0, 5.0, N)
    xs, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    ys = np.asarray(y)[None] + 0.01 * rng.standard_normal((B, N, 2))
    return dict(jmodel=jmodel, tmodel=_port_model(jmodel), ts=np.asarray(ts),
                xs=np.asarray(xs), y=np.asarray(y), ys=ys, memo={})


def _inner(method, mode, port):
    if method == "sequential_rts":
        return (SequentialOptions if port else JSequentialOptions)(mode=mode)
    if method == "parallel_two_filter":
        return (TwoFilterOptions if port else JTwoFilterOptions)(
            nsub=NSUB, mode=mode)
    if method == "parallel_kernel" and port:
        return KernelOptions(nsub=NSUB, mode=mode)
    return (ParallelOptions if port else JParallelOptions)(nsub=NSUB,
                                                           mode=mode)


def _solve_both(ct, method, mode, layout="single", iterations=ITERS,
                **kw):
    """(reference Solution, port Solution) of one problem; the port's
    ``parallel_kernel`` is held against the reference's ``parallel_rts``."""
    outer = {k: kw.pop(k) for k in ("divergence_correction",) if k in kw}
    jmethod = "parallel_rts" if method == "parallel_kernel" else method
    key = (jmethod, mode, layout, iterations, repr(sorted(kw.items())),
           repr(outer))

    def problem(P, m):
        if layout == "single":
            return P.single(m, ct["ts"], ct["y"], **kw)
        return P.stacked(m, ct["ts"], ct["ys"], **kw)

    if key not in ct["memo"]:
        jm = ct["jmodel"]
        ct["memo"][key] = JEstimator(jm, method=jmethod, options=JIteratedOptions(
            inner=_inner(jmethod, mode, False), iterations=iterations,
            **outer)).solve(problem(JProblem, jm))
    tm = ct["tmodel"]
    got = Estimator(tm, method=method, device="cpu", options=IteratedOptions(
        inner=_inner(method, mode, True), iterations=iterations,
        **outer)).solve(problem(Problem, tm))
    return ct["memo"][key], got


def _assert_matches(got, want, rtol=RTOL):
    for f in ("x", "cost", "cost_trace", "step_norms"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape, f
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=0,
                                   err_msg=f)
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S), rtol=rtol,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# the iterated smoother vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,mode", [
    ("parallel_rts", "discrete"),
    ("parallel_rts", "euler"),
    ("sequential_rts", "discrete"),
    ("sequential_rts", "euler"),
    ("parallel_kernel", "discrete"),
    ("parallel_kernel", "euler"),
    ("parallel_two_filter", "discrete"),
])
def test_ieks_matches_reference(ct, method, mode):
    want, got = _solve_both(ct, method, mode)
    _assert_matches(got, want)
    trace = got.cost_trace
    assert trace.shape == (ITERS,) and float(got.cost) == float(trace[-1])
    assert float(trace[-1]) < float(trace[0])


@pytest.mark.parametrize("shape", ["point", "trajectory"])
def test_warm_starts_match_reference(ct, shape):
    """``x_init`` ``(nx,)`` or ``(N+1, nx)``, compared with the reference's
    own outputs for the same warm start."""
    rng = np.random.default_rng(3)
    x_init = (np.array([4.9, 5.1, 0.05, 0.25, 0.01]) if shape == "point"
              else ct["xs"] + 0.01 * rng.standard_normal(ct["xs"].shape))
    want, got = _solve_both(ct, "sequential_rts", "discrete", x_init=x_init)
    _assert_matches(got, want)


def test_stacked_records_with_per_record_warm_starts(ct):
    """Three records stacked (one pass per iteration over all of them) on
    the main path, each with its own warm-start point."""
    x_init = np.asarray(ct["jmodel"].m0)[None] + np.array(
        [[0.0] * 5, [0.05, -0.05, 0.0, 0.0, 0.0], [0.0, 0.0, 0.02, 0.0, 0.0]])
    want, got = _solve_both(ct, "parallel_kernel", "euler",
                            layout="stacked", x_init=x_init)
    assert tuple(got.x.shape) == (B, N + 1, 5)
    assert tuple(got.cost_trace.shape) == (B, ITERS)
    _assert_matches(got, want)
    # the same warm starts as per-record trajectories give the same solve
    tm = ct["tmodel"]
    traj = np.repeat(x_init[:, None], N + 1, axis=1)
    est = Estimator(tm, method="parallel_kernel", device="cpu",
                    options=IteratedOptions(
                        inner=KernelOptions(nsub=NSUB, mode="euler"),
                        iterations=ITERS))
    again = est.solve(Problem.stacked(tm, ct["ts"], ct["ys"], x_init=traj))
    torch.testing.assert_close(again.x, got.x, rtol=0, atol=0)


def test_mask_and_prior_match_reference(ct):
    rng = np.random.default_rng(4)
    mask = (rng.random(N) > 0.2).astype(np.float64)
    S0 = np.diag([90.0, 110.0, 80.0, 120.0, 30.0])
    v0 = S0 @ np.array([5.02, 4.97, 0.01, 0.29, 0.0])
    want, got = _solve_both(ct, "sequential_rts", "discrete",
                            measurement_mask=mask, prior=(S0, v0))
    _assert_matches(got, want)


def test_divergence_correction_matches_reference(ct):
    want, got = _solve_both(ct, "sequential_rts", "discrete", iterations=2,
                            divergence_correction=True)
    _assert_matches(got, want)


def test_diagnostics_off_skips_the_traces(ct):
    tm = ct["tmodel"]
    p = Problem.single(tm, ct["ts"], ct["y"])
    opts = IteratedOptions(inner=ParallelOptions(nsub=NSUB, mode="euler"),
                           iterations=2)
    on = Estimator(tm, device="cpu", options=opts).solve(p)
    off = Estimator(tm, device="cpu", options=opts,
                    diagnostics=False).solve(p)
    assert off.cost is None and off.cost_trace is None
    assert off.step_norms is None
    torch.testing.assert_close(off.x, on.x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_grid_and_cost_match_reference(ct):
    """Linearisation (Jacobians by ``torch.func.jacfwd`` under ``vmap``),
    the divergence gradient, the time-reversed grid and the true cost."""
    jm, tm = ct["jmodel"], ct["tmodel"]
    ts, y = ct["ts"], ct["y"]
    rng = np.random.default_rng(5)
    xbar = ct["xs"] + 0.05 * rng.standard_normal(ct["xs"].shape)
    mask = (rng.random(N) > 0.3).astype(np.float64)
    prior = (np.diag([50.0, 60.0, 70.0, 80.0, 20.0]), rng.standard_normal(5))
    for div in (False, True):
        want = jax.jit(lambda *a: jsde.grid_lqt_from_nonlinear(
            jm, *a[:3], divergence_correction=div, measurement_mask=a[3],
            prior=a[4:]))(*map(jnp.asarray, (ts, y, xbar, mask) + prior))
        got = grid_lqt_from_nonlinear(
            tm, _t(ts), _t(y), _t(xbar), divergence_correction=div,
            measurement_mask=_t(mask), prior=tuple(map(_t, prior)))
        for f, g in got._asdict().items():
            w = getattr(want, f)
            if w is None:
                assert g is None, f
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-10, atol=1e-12,
                                           err_msg=f)
        want_c = jsde.om_cost_nonlinear(
            jm, jnp.asarray(ts), jnp.asarray(y), jnp.asarray(xbar),
            divergence_correction=div, measurement_mask=jnp.asarray(mask),
            prior=tuple(map(jnp.asarray, prior)))
        got_c = om_cost_nonlinear(
            tm, _t(ts), _t(y), _t(xbar), divergence_correction=div,
            measurement_mask=_t(mask), prior=tuple(map(_t, prior)))
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-10)


def test_record_dims_linearise_as_single_records(ct):
    """A grid with records after the time axis equals each record's own."""
    tm = ct["tmodel"]
    ts = _t(ct["ts"])
    rng = np.random.default_rng(6)
    xbar = _t(ct["xs"][:, None] + 0.05 * rng.standard_normal((N + 1, 2, 5)))
    ys = _t(ct["ys"][:2]).movedim(0, 1)
    both = grid_lqt_from_nonlinear(tm, ts[:, None].expand(-1, 2), ys, xbar)
    for r in range(2):
        one = grid_lqt_from_nonlinear(tm, ts, ys[:, r], xbar[:, r])
        for f in ("F", "c", "H", "r", "Q", "Rinv", "y"):
            torch.testing.assert_close(getattr(both, f)[:, r],
                                       getattr(one, f), rtol=0, atol=0)


def test_simulate_nonlinear_shapes_and_generator(ct):
    tm = ct["tmodel"]
    ts = _t(ct["ts"])

    def sim(seed, t):
        return simulate_nonlinear(tm, t, torch.Generator().manual_seed(seed))

    xs, y = sim(0, ts)
    assert xs.shape == (N + 1, 5) and y.shape == (N, 2)
    assert bool(torch.isfinite(xs).all() and torch.isfinite(y).all())
    xs2, y2 = sim(0, ts)
    torch.testing.assert_close(xs2, xs, rtol=0, atol=0)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    xb, yb = sim(1, ts[:, None].expand(-1, 4))
    assert xb.shape == (N + 1, 4, 5) and yb.shape == (N, 4, 2)
    assert not torch.equal(xb[:, 0], xb[:, 1])
    # the turn rate moves only through its noise: a random walk of
    # sigma_w^2 = 4e-4 per unit time over tf = 5
    assert float((xb[-1, :, 4] - xb[0, :, 4]).abs().max()) < 0.5


def test_coordinated_turn_config_matches_reference():
    jm, tm = JCTConfig().model(), CoordinatedTurnConfig().model()
    for f in ("Q", "R", "m0", "P0"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=0,
                                   atol=0, err_msg=f)
    assert dataclasses.asdict(CoordinatedTurnConfig()) == dataclasses.asdict(
        JCTConfig())
    rng = np.random.default_rng(7)
    for x in rng.standard_normal((4, 5)):
        t = 0.3
        for fn in ("f", "h"):
            want = getattr(jm, fn)(jnp.asarray(x), t)
            got = getattr(tm, fn)(_t(x), torch.tensor(t, dtype=torch.float64))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-14, atol=1e-15)
            jac = Taylor()(getattr(tm, fn), _t(x), torch.tensor(t))[0]
            np.testing.assert_allclose(
                jac.numpy(), np.asarray(jax.jacfwd(getattr(jm, fn))(
                    jnp.asarray(x), t)), rtol=1e-14, atol=1e-15)


# ---------------------------------------------------------------------------
# options, resolution and validation
# ---------------------------------------------------------------------------


def test_iterated_options_validation_mirrors_reference(ct):
    jm, tm = ct["jmodel"], ct["tmodel"]
    bad = {
        ValueError: [dict(iterations=0), dict(iterations=1.5),
                     dict(linearization="bogus")],
        TypeError: [dict(inner=object()), dict(linearization=3)],
    }
    for exc, cases in bad.items():
        for kw in cases:
            for cls in (IteratedOptions, JIteratedOptions):
                with pytest.raises(exc):
                    cls(**kw)
    assert isinstance(IteratedOptions().linearization, Taylor)
    linear = _linear()
    for (E, M, Opt, Inner, Seq) in (
            (Estimator, tm, IteratedOptions, ParallelOptions,
             SequentialOptions),
            (JEstimator, jm, JIteratedOptions, JParallelOptions,
             JSequentialOptions)):
        kw = dict(device="cpu") if E is Estimator else {}
        with pytest.raises(TypeError, match="must be ParallelOptions"):
            E(M, options=Opt(inner=Seq()), **kw)
        with pytest.raises(TypeError, match="or IteratedOptions"):
            E(M, method="sequential_rts", options=Inner(), **kw)
        est = E(M, options=Inner(nsub=NSUB), **kw)       # bare inner wraps
        assert isinstance(est.options, Opt)
        assert est.options.inner == Inner(nsub=NSUB)
        assert E(M, **kw).options.inner == Inner()        # inner=None
    with pytest.raises(TypeError, match="linear models take"):
        Estimator(linear, options=IteratedOptions(), device="cpu")


@dataclasses.dataclass(frozen=True)
class _Regression(Taylor):
    """A strategy with a residual covariance: Taylor's expansion with the
    residual ``scale * I`` at every point (``covs`` is the spread the
    grid builder passes, ``P0``)."""

    has_residual = True
    scale = 1e-3

    def linearize_grid(self, g, xb, tl, covs=None):
        assert tuple(covs.shape) == (5, 5)
        A, b, _ = super().linearize_grid(g, xb, tl)
        nz = A.shape[-2]
        return A, b, self.scale * torch.eye(nz, dtype=A.dtype).expand(
            A.shape[:-2] + (nz, nz))


@dataclasses.dataclass(frozen=True)
class _JRegression(JTaylor):
    """The same strategy for the reference package."""

    has_residual = True
    scale = 1e-3

    def linearize_grid(self, g, xb, tl, covs=None):
        A, b, _ = super().linearize_grid(g, xb, tl)
        nz = A.shape[-2]
        return A, b, self.scale * jnp.broadcast_to(jnp.eye(nz), A.shape[:-2]
                                                   + (nz, nz))


def test_sigma_point_linearizations_resolve_to_slr(ct):
    """The sigma-point names resolve to SLR strategies, by name and through
    the options; a strategy's residual covariance is folded into Q and R
    as the reference folds it."""
    for name, family in (("unscented", Unscented), ("cubature", Cubature),
                         ("gauss_hermite", GaussHermite)):
        for lin in (get_linearization(name),
                    IteratedOptions(linearization=name).linearization):
            assert isinstance(lin, SLR) and lin.has_residual
            assert isinstance(lin.family, family) and lin.spread == 0.01
    assert isinstance(get_linearization(None), Taylor)
    jm, tm = ct["jmodel"], ct["tmodel"]
    rng = np.random.default_rng(9)
    xbar = ct["xs"] + 0.05 * rng.standard_normal(ct["xs"].shape)
    want = jsde.grid_lqt_from_nonlinear(
        jm, *map(jnp.asarray, (ct["ts"], ct["y"], xbar)),
        linearization=_JRegression())
    got = grid_lqt_from_nonlinear(tm, _t(ct["ts"]), _t(ct["y"]), _t(xbar),
                                  linearization=_Regression())
    plain = grid_lqt_from_nonlinear(tm, _t(ct["ts"]), _t(ct["y"]), _t(xbar))
    torch.testing.assert_close(
        got.Q, plain.Q + _Regression.scale * torch.eye(5, dtype=torch.float64),
        rtol=0, atol=1e-18)
    for f in ("F", "c", "H", "r", "Q", "Rinv", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-10,
                                   atol=1e-12, err_msg=f)


@dataclasses.dataclass(frozen=True)
class _OuterOptions(IteratedOptions):
    """An iterated nonlinear method's options (the resolution rules only)."""

    inner_method: str = "parallel_rts"


def test_iterated_method_resolution(ct, monkeypatch):
    """A method registered with ``IteratedOptions`` options is nonlinear:
    it needs a nonlinear model, wraps a bare inner ``SolverOptions``,
    refuses a nonlinear ``inner_method`` and solves through that method."""
    monkeypatch.setitem(registry._METHODS, "outer_test", registry.MethodSpec(
        "outer_test", None, _OuterOptions))
    tm = ct["tmodel"]
    assert registry.get_method("outer_test").nonlinear
    assert not registry.get_method("parallel_rts").nonlinear
    linear = _linear()
    with pytest.raises(TypeError, match="needs a NonlinearSDE"):
        Estimator(linear, method="outer_test", device="cpu")
    with pytest.raises(ValueError, match="itself an iterated"):
        Estimator(tm, method="outer_test", device="cpu",
                  options=_OuterOptions(inner_method="outer_test"))
    with pytest.raises(TypeError, match="must be ParallelOptions"):
        Estimator(tm, method="outer_test", device="cpu",
                  options=_OuterOptions(inner=SequentialOptions()))
    inner = ParallelOptions(nsub=NSUB, mode="discrete")
    est = Estimator(tm, method="outer_test", device="cpu", options=inner)
    assert est.options == _OuterOptions(inner=inner)
    p = Problem.single(tm, ct["ts"], ct["y"])
    plain = Estimator(tm, device="cpu", options=IteratedOptions(inner=inner))
    torch.testing.assert_close(est.solve(p).x, plain.solve(p).x, rtol=0,
                               atol=0)


def test_problem_x_init_validation_mirrors_reference(ct):
    jm, tm = ct["jmodel"], ct["tmodel"]
    ts, y, ys = ct["ts"], ct["y"], ct["ys"]
    bad = {
        "x_init must be (5,) or": lambda P, m: P.single(
            m, ts, y, x_init=np.zeros(4)),
        "x_init must be shared": lambda P, m: P.stacked(
            m, ts, ys, x_init=np.zeros((B + 1, 5))),
    }
    for match, build in bad.items():
        for P, m in ((JProblem, jm), (Problem, tm)):
            with pytest.raises(ValueError, match=match.replace("(", r"\(")
                               .replace(")", r"\)")):
                build(P, m)
    linear = _linear()
    with pytest.raises(ValueError, match="only meaningful"):
        Problem.single(linear, ts, y, x_init=np.zeros(5))


def test_ambiguous_stacked_x_init_reads_per_record(ct):
    """With B == N+1 a ``(B, nx)`` warm start is read per record, as in
    the reference; tiling to ``(B, N+1, nx)`` gives the same solve."""
    tm = ct["tmodel"]
    n = 2
    ts = ct["ts"][:n + 1]
    ys = ct["ys"][:, :n]                      # B = 3 = n + 1 records
    rng = np.random.default_rng(8)
    x_init = np.asarray(tm.m0)[None] + 0.1 * rng.standard_normal((B, 5))
    est = Estimator(tm, method="sequential_rts", device="cpu",
                    options=IteratedOptions(
                        inner=SequentialOptions(mode="discrete"),
                        iterations=1))
    a = est.solve(Problem.stacked(tm, ts, ys, x_init=x_init))
    b = est.solve(Problem.stacked(
        tm, ts, ys, x_init=np.repeat(x_init[:, None], n + 1, axis=1)))
    torch.testing.assert_close(a.x, b.x, rtol=0, atol=0)
    shared = est.solve(Problem.stacked(
        tm, ts, ys, x_init=np.repeat(x_init[None], B, axis=0)))
    assert not torch.equal(shared.x, a.x)


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
