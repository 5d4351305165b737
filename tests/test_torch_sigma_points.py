"""Sigma-point solves in the PyTorch port, held against the JAX reference.

The unit sigma points, the statistical linear regression (SLR) of one
point and of a grid, the SLR grid of the coordinated-turn model and
``method="sigma_point"`` (the iterated posterior-linearisation smoother)
through the port's ``Estimator`` on single, stacked-and-masked, ragged and
warm-started problems.  Both packages get the same numpy inputs: the
reference's coordinated-turn model (its ``Q``, ``R``, ``m0``, ``P0``; the
port's own torch ``f``/``h``) and the reference's simulated measurements,
N = 200, as in the reference's ``tests/test_linearize.py``.  Tolerances
are that file's, or tighter where the arithmetic is the same: points and
weights at 1e-15, moments at 1e-12, affine recovery at 1e-11, one point's
SLR at 1e-12, the grid at 1e-10, solves at 1e-9.  Warm starts are compared
with the reference's outputs directly, not with its drift bound.
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
from repro import linearize as jlin
from repro.core import Estimator as JEstimator
from repro.core import LinearSDE as JLinearSDE
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import SigmaPointOptions as JSigmaPointOptions
from repro.core import get_method as jget_method
from repro.core import method_names as jmethod_names
from repro.core import sde as jsde
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro_torch import linearize as tlin
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
    SigmaPointOptions,
    get_method,
    grid_lqt_from_nonlinear,
    method_names,
)

torch.set_num_threads(1)

# torch's forward-mode AD (the Taylor comparisons) loads its decompositions
# through ``torch.jit.script``, which this torch build marks deprecated: a
# third-party deprecation, not the port's.
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

N, NSUB = 200, 10
SOLVE_TOL = 1e-9
# (class name, keyword arguments): the reference tests' FAMILIES
FAMILIES = [("Unscented", {}), ("Unscented", dict(alpha=0.5, kappa=3.0)),
            ("Cubature", {}), ("GaussHermite", dict(order=3)),
            ("GaussHermite", dict(order=5))]
FAMILY_IDS = [f"{c}{kw or ''}" for c, kw in FAMILIES]
PACKAGES = ["port", "reference"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _family(pkg, name, kw):
    return getattr(pkg, name)(**kw)


@pytest.fixture(scope="module")
def ct():
    """The reference's model and measurements (N = 200), the port's model,
    and a memo of reference solves."""
    jmodel = coordinated_turn()
    ts = time_grid(0.0, 5.0, N)
    xs, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(2))
    ref = CoordinatedTurnConfig().model()
    tmodel = nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)
    return dict(jmodel=jmodel, tmodel=tmodel, ts=np.asarray(ts),
                xs=np.asarray(xs), y=np.asarray(y), memo={})


def _opts(port, inner_method="parallel_rts", **kw):
    """SigmaPointOptions of either package, discrete inner options."""
    if port:
        inner = {"parallel_rts": ParallelOptions(nsub=NSUB, mode="discrete"),
                 "parallel_kernel": KernelOptions(nsub=NSUB, mode="discrete"),
                 "sequential_rts": SequentialOptions(mode="discrete")}[
            inner_method]
        return SigmaPointOptions(inner_method=inner_method, inner=inner, **kw)
    return JSigmaPointOptions(inner=JParallelOptions(nsub=NSUB,
                                                     mode="discrete"), **kw)


def _reference(ct, key, build):
    """A reference solve, once per module."""
    if key not in ct["memo"]:
        ct["memo"][key] = build()
    return ct["memo"][key]


def _assert_close(got, want, fields=("x", "cost", "cost_trace",
                                     "step_norms")):
    for f in fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape, f
        np.testing.assert_allclose(g.numpy(), w, rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL, err_msg=f)


# ---------------------------------------------------------------------------
# sigma points and the regression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("name,kw", FAMILIES, ids=FAMILY_IDS)
def test_unit_points_match_reference(name, kw, n):
    got = tlin.unit_points(_family(tlin, name, kw), n)
    want = jlin.unit_points(_family(jlin, name, kw), n)
    for f in ("points", "wm", "wc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-15, err_msg=f)
    fam = _family(tlin, name, kw)
    assert got.points.shape == (fam.num_points(n), n)
    np.testing.assert_allclose(np.sum(got.wm), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.wm @ got.points, np.zeros(n), rtol=0,
                               atol=1e-12)
    cov = np.einsum("s,si,sj->ij", got.wc, got.points, got.points)
    np.testing.assert_allclose(cov, np.eye(n), rtol=0, atol=1e-12)


def test_unit_points_validation_mirrors_reference():
    for pkg, zeros in ((tlin, torch.zeros), (jlin, jnp.zeros)):
        with pytest.raises(ValueError, match="alpha"):
            pkg.Unscented(alpha=0.0)
        with pytest.raises(ValueError, match="lambda"):
            pkg.unit_points(pkg.Unscented(alpha=1.0, kappa=-7.0), 5)
        for order in (0, 1):
            with pytest.raises(ValueError, match="order"):
                pkg.GaussHermite(order=order)
        with pytest.raises(ValueError, match="points"):
            pkg.unit_points(pkg.GaussHermite(order=9), 7)
        assert pkg.unit_points(pkg.Cubature(), 4) is pkg.unit_points(
            pkg.Cubature(), 4)
        with pytest.raises(TypeError, match="SigmaPointFamily"):
            pkg.SLR(family="unscented")
        with pytest.raises(ValueError, match="spread"):
            pkg.cubature(spread=0.0)
        with pytest.raises(ValueError, match="spread covariance"):
            pkg.cubature()(lambda x, t: x, zeros(2), 0.0)


@pytest.mark.parametrize("name,kw", FAMILIES, ids=FAMILY_IDS)
def test_slr_recovers_affine_exactly(name, kw):
    """SLR of an affine function returns (A, b) exactly and Omega == 0."""
    rng = np.random.default_rng(3)
    A_true = _t(rng.standard_normal((3, 4)))
    b_true = _t(rng.standard_normal(3))
    cov = _t(np.diag(rng.uniform(0.5, 2.0, 4)))
    m = _t(rng.standard_normal(4))
    A, b, Omega = tlin.SLR(_family(tlin, name, kw))(
        lambda x, t: A_true @ x + b_true, m, 0.0, cov)
    for got, want in ((A, A_true), (b, b_true), (Omega, torch.zeros(3, 3))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-11)


@pytest.mark.parametrize("name,kw", FAMILIES, ids=FAMILY_IDS)
def test_slr_point_matches_reference(ct, name, kw):
    """One point's regression of the coordinated turn's drift and
    measurement functions, at random points and spread covariances."""
    rng = np.random.default_rng(4)
    jm, tm = ct["jmodel"], ct["tmodel"]
    for _ in range(3):
        m = np.array([5.0, 5.0, 0.0, 0.3, 0.1]) + rng.standard_normal(5)
        L = rng.standard_normal((5, 5))
        cov = L @ L.T / 5 + 0.1 * np.eye(5)
        spread = float(rng.uniform(0.01, 1.0))
        t = float(rng.uniform(0.0, 5.0))
        for fn in ("f", "h"):
            want = jlin.slr_linearize_point(
                getattr(jm, fn), jnp.asarray(m), t, jnp.asarray(cov),
                _family(jlin, name, kw), spread)
            got = tlin.slr_linearize_point(
                getattr(tm, fn), _t(m), t, _t(cov), _family(tlin, name, kw),
                spread)
            for g, w, f in zip(got, want, ("A", "b", "Omega")):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=f"{fn} {f}")


@pytest.mark.parametrize("lin", ["unscented", "cubature", "gauss_hermite"])
def test_slr_grid_matches_reference(ct, lin):
    """The SLR grid (residuals folded into Q and R) against the
    reference's ``grid_lqt_from_nonlinear(linearization=...)``, and a grid
    of two records against each record's own."""
    jm, tm = ct["jmodel"], ct["tmodel"]
    ts, y = ct["ts"], ct["y"]
    rng = np.random.default_rng(5)
    xbar = ct["xs"] + 0.05 * rng.standard_normal(ct["xs"].shape)
    want = jsde.grid_lqt_from_nonlinear(
        jm, jnp.asarray(ts), jnp.asarray(y), jnp.asarray(xbar),
        linearization=lin)
    got = grid_lqt_from_nonlinear(tm, _t(ts), _t(y), _t(xbar),
                                  linearization=lin)
    tol = {"Q": dict(rtol=1e-10, atol=1e-14), "Rinv": dict(rtol=1e-10,
                                                       atol=1e-8)}
    for f in ("dt", "F", "c", "H", "r", "Q", "Rinv", "y", "S_T", "v_T"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            **tol.get(f, dict(rtol=0, atol=1e-10)), err_msg=f)
    assert got.lin is None and want.lin is None
    # Omega is PSD and nonzero on this nonlinear model
    Of = torch.flip(got.Q, (0,)) - tm.Q
    assert float(Of.abs().max()) > 0
    assert float(torch.linalg.eigvalsh(Of).min()) > -1e-12

    xb2 = _t(np.stack([xbar, ct["xs"]], axis=1))              # (N+1, 2, nx)
    ys2 = _t(np.stack([y, y[::-1]], axis=1))
    both = grid_lqt_from_nonlinear(tm, _t(ts)[:, None].expand(-1, 2), ys2,
                                   xb2, linearization=lin)
    for r in range(2):
        one = grid_lqt_from_nonlinear(tm, _t(ts), ys2[:, r], xb2[:, r],
                                      linearization=lin)
        for f in ("F", "c", "H", "r", "Q", "Rinv"):
            torch.testing.assert_close(getattr(both, f)[:, r],
                                       getattr(one, f), rtol=1e-14,
                                       atol=1e-14)


def test_slr_equals_taylor_on_a_linear_model(ct):
    """On a model that is linear in x the SLR grid equals the Taylor grid
    (Omega == 0 folds in nothing), at the reference test's tolerances."""
    from repro_torch.core import NonlinearSDE

    tm = ct["tmodel"]
    F = _t(np.diag([0.9, 0.8, 1.1, 1.0, 0.95]))
    model = NonlinearSDE(f=lambda x, t: F @ x, h=lambda x, t: x[:2],
                         Q=torch.eye(5, dtype=torch.float64) * 1e-3,
                         R=torch.eye(2, dtype=torch.float64) * 1e-2,
                         m0=tm.m0, P0=tm.P0)
    xbar = tm.m0.expand(N + 1, 5)
    ts, y = _t(ct["ts"]), _t(ct["y"])
    g_t = grid_lqt_from_nonlinear(model, ts, y, xbar, linearization="taylor")
    g_s = grid_lqt_from_nonlinear(model, ts, y, xbar,
                                  linearization="cubature")
    for f in ("F", "c", "H", "r"):
        np.testing.assert_allclose(getattr(g_s, f), getattr(g_t, f), rtol=0,
                                   atol=1e-10, err_msg=f)
    np.testing.assert_allclose(g_s.Q, g_t.Q, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(g_s.Rinv, g_t.Rinv, rtol=1e-10, atol=1e-8)


# ---------------------------------------------------------------------------
# method resolution, both packages
# ---------------------------------------------------------------------------


def _pkg(which):
    """One package's surface for the resolution tests."""
    if which == "port":
        return dict(E=lambda *a, **k: Estimator(*a, device="cpu", **k),
                    S=SigmaPointOptions, get_method=get_method,
                    names=method_names, lin=tlin,
                    model=lambda ct: ct["tmodel"],
                    linear=lambda: LinearSDE(
                        F=torch.zeros(2, 2), c=torch.zeros(2), H=torch.eye(2),
                        r=torch.zeros(2), Q=torch.eye(2), R=torch.eye(2),
                        m0=torch.zeros(2), P0=torch.eye(2)))
    return dict(E=JEstimator, S=JSigmaPointOptions, get_method=jget_method,
                names=jmethod_names, lin=jlin, model=lambda ct: ct["jmodel"],
                linear=lambda: JLinearSDE(
                    F=jnp.zeros((2, 2)), c=jnp.zeros(2), H=jnp.eye(2),
                    r=jnp.zeros(2), Q=jnp.eye(2), R=jnp.eye(2),
                    m0=jnp.zeros(2), P0=jnp.eye(2)))


@pytest.mark.parametrize("which", PACKAGES)
def test_sigma_point_options_validate(ct, which):
    P = _pkg(which)
    o = P["S"]()
    assert isinstance(o.linearization, P["lin"].SLR)
    assert isinstance(o.linearization.family, P["lin"].Unscented)
    assert o.inner_method == "parallel_rts"
    assert hash(o) == hash(P["S"](linearization=P["lin"].unscented()))
    with pytest.raises(ValueError, match="inner_method"):
        P["S"](inner_method="")
    with pytest.raises(ValueError, match="method must be one of"):
        P["E"](P["model"](ct), method="sigma_point",
               options=P["S"](inner_method="bogus"))


@pytest.mark.parametrize("which", PACKAGES)
def test_sigma_point_method_registered(which):
    P = _pkg(which)
    assert "sigma_point" in P["names"]()
    spec = P["get_method"]("sigma_point")
    assert spec.nonlinear and not P["get_method"]("parallel_rts").nonlinear
    with pytest.raises(TypeError, match="not a grid\\s+solver"):
        spec.solver(None, P["S"]())


@pytest.mark.parametrize("which", PACKAGES)
def test_sigma_point_requires_nonlinear_model(which):
    P = _pkg(which)
    with pytest.raises(TypeError, match="NonlinearSDE"):
        P["E"](P["linear"](), method="sigma_point")


@pytest.mark.parametrize("which", PACKAGES)
def test_sigma_point_options_rejected_by_linear_methods(ct, which):
    P = _pkg(which)
    with pytest.raises(TypeError, match="sigma_point"):
        P["E"](P["model"](ct), method="parallel_rts", options=P["S"]())


@pytest.mark.parametrize("which", PACKAGES)
def test_nested_nonlinear_inner_method_rejected(ct, which):
    P = _pkg(which)
    with pytest.raises(ValueError, match="itself an"):
        P["E"](P["model"](ct), method="sigma_point",
               options=P["S"](inner_method="sigma_point"))


def test_bare_inner_options_wrap_into_sigma_point_options(ct):
    tm = ct["tmodel"]
    inner = ParallelOptions(nsub=NSUB, mode="discrete")
    est = Estimator(tm, method="sigma_point", device="cpu", options=inner)
    assert est.options == SigmaPointOptions(inner=inner)
    est = Estimator(tm, method="sigma_point", device="cpu")
    assert est.options.inner == ParallelOptions()
    with pytest.raises(TypeError, match="must be ParallelOptions"):
        Estimator(tm, method="sigma_point", device="cpu",
                  options=SigmaPointOptions(inner=SequentialOptions()))


# ---------------------------------------------------------------------------
# method="sigma_point" against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lin", ["unscented", "cubature"])
def test_sigma_point_single_matches_reference(ct, lin):
    jm, tm = ct["jmodel"], ct["tmodel"]
    want = _reference(ct, ("single", lin), lambda: JEstimator(
        jm, method="sigma_point", options=_opts(False, linearization=lin)
    ).solve(JProblem.single(jm, ct["ts"], ct["y"])))
    got = Estimator(tm, method="sigma_point", device="cpu",
                    options=_opts(True, linearization=lin)).solve(
        Problem.single(tm, ct["ts"], ct["y"]))
    _assert_close(got, want)
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S),
                               rtol=SOLVE_TOL, atol=1e-8)
    trace = got.cost_trace
    assert trace.shape == (5,) and float(got.cost) == float(trace[-1])
    assert float(trace[-1]) < float(trace[0])


def test_sigma_point_stacked_and_masked_matches_reference(ct):
    """Two stacked records with a per-record mask: the reference's stacked
    solve, and each record's own single solve."""
    jm, tm = ct["jmodel"], ct["tmodel"]
    y2 = np.stack([ct["y"], ct["y"][::-1]])
    mask = np.ones((2, N))
    mask[1, N // 2:] = 0.0
    want = _reference(ct, "stacked", lambda: JEstimator(
        jm, method="sigma_point", options=_opts(False)).solve(
        JProblem.stacked(jm, ct["ts"], y2, measurement_mask=mask)))
    est = Estimator(tm, method="sigma_point", device="cpu",
                    options=_opts(True))
    got = est.solve(Problem.stacked(tm, ct["ts"], y2, measurement_mask=mask))
    assert tuple(got.x.shape) == (2, N + 1, 5)
    _assert_close(got, want)
    for b in range(2):
        one = est.solve(Problem.single(tm, ct["ts"], y2[b],
                                       measurement_mask=mask[b]))
        np.testing.assert_allclose(got.x[b].numpy(), one.x.numpy(),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL)


def test_sigma_point_ragged_matches_reference(ct):
    jm, tm = ct["jmodel"], ct["tmodel"]
    ts, y = ct["ts"], ct["y"]
    recs = [(ts[:101], y[:100]), (ts[:151], y[:150])]
    want = _reference(ct, "ragged", lambda: JEstimator(
        jm, method="sigma_point", options=_opts(False)).solve(
        JProblem.ragged(jm, recs)))
    got = Estimator(tm, method="sigma_point", device="cpu",
                    options=_opts(True)).solve(Problem.ragged(tm, recs))
    assert len(got) == 2
    for (ts_i, y_i), g, w in zip(recs, got, want):
        assert tuple(g.x.shape) == (y_i.shape[0] + 1, 5)
        _assert_close(g, w)
    assert dataclasses.asdict(got[0].padding) == dataclasses.asdict(
        want[0].padding)


def test_sigma_point_warm_start_matches_reference(ct):
    """``x_init`` = the cold solve's trajectory, the same array to both."""
    jm, tm = ct["jmodel"], ct["tmodel"]
    cold = _reference(ct, ("single", "unscented"), lambda: JEstimator(
        jm, method="sigma_point", options=_opts(False)).solve(
        JProblem.single(jm, ct["ts"], ct["y"])))
    x_init = np.asarray(cold.x)
    want = _reference(ct, "warm", lambda: JEstimator(
        jm, method="sigma_point", options=_opts(False)).solve(
        JProblem.single(jm, ct["ts"], ct["y"], x_init=x_init)))
    got = Estimator(tm, method="sigma_point", device="cpu",
                    options=_opts(True)).solve(
        Problem.single(tm, ct["ts"], ct["y"], x_init=x_init))
    _assert_close(got, want)


def test_sigma_point_with_taylor_equals_ieks(ct):
    """``linearization="taylor"`` makes ``sigma_point`` the plain IEKS:
    the same grids, the same inner solver, the same result."""
    tm = ct["tmodel"]
    p = Problem.single(tm, ct["ts"], ct["y"])
    inner = ParallelOptions(nsub=NSUB, mode="discrete")
    ieks = Estimator(tm, device="cpu",
                     options=IteratedOptions(inner=inner)).solve(p)
    sp = Estimator(tm, method="sigma_point", device="cpu",
                   options=SigmaPointOptions(linearization="taylor",
                                             inner=inner)).solve(p)
    torch.testing.assert_close(sp.x, ieks.x, rtol=0, atol=0)
    torch.testing.assert_close(sp.cost_trace, ieks.cost_trace, rtol=0,
                               atol=0)


@pytest.mark.parametrize("inner_method", ["sequential_rts", "parallel_kernel"])
def test_sigma_point_inner_solvers_agree(ct, inner_method):
    """Other inner methods against ``parallel_rts`` at the reference's
    1e-7; ``parallel_kernel`` runs its kernel's plain version here (the
    same scan as ``parallel_rts``) and agrees to round-off."""
    tm = ct["tmodel"]
    p = Problem.single(tm, ct["ts"], ct["y"])

    def solve(m):
        return Estimator(tm, method="sigma_point", device="cpu",
                         options=_opts(True, inner_method=m)).solve(p)

    got, ref = solve(inner_method), solve("parallel_rts")
    assert bool(torch.isfinite(got.x).all())
    tol = 1e-12 if inner_method == "parallel_kernel" else 1e-7
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=tol,
                               atol=tol)


def test_sigma_point_cost_not_worse_than_taylor(ct):
    """The reference's acceptance property on the port: the posterior-
    linearisation smoother's final cost is at most the IEKS's at the same
    iteration count (tiny float slack)."""
    tm = ct["tmodel"]
    p = Problem.single(tm, ct["ts"], ct["y"])
    inner = ParallelOptions(nsub=NSUB, mode="discrete")
    tay = Estimator(tm, device="cpu",
                    options=IteratedOptions(inner=inner)).solve(p)
    for lin in ("unscented", "cubature"):
        sp = Estimator(tm, method="sigma_point", device="cpu",
                       options=_opts(True, linearization=lin)).solve(p)
        assert float(sp.cost) <= float(tay.cost) * (1 + 1e-6), lin


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
