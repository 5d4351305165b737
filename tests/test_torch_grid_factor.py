"""Square roots of a time-varying noise matrix over a long grid, in
chunks.

cuSOLVER's batched ``eigh`` refuses more than about 23 to 32 thousand
matrices in one call on the card (the limit falls with the matrix size),
so ``repro_torch.core.sde._psd_sqrt`` runs its eigendecompositions in
chunks of at most ``EIGH_CHUNK`` matrices (``cholesky``, ``inv`` and
``pinv`` take a whole grid).  Here the constant is patched to ``CHUNK``,
so that a grid of a few hundred points spans several chunks, and the
paper's Wiener velocity model (section 5.1, ``Q`` singular) gets a
time-varying ``Q(t) = Q (1 + 0.5 sin t)``.  The chunked square roots
match the JAX package's ``_psd_sqrt`` at rtol 1e-12 (and, where eigh
leaves round-off on a singular Q's null eigenvalues, count them as
zero); the simulators give the same bits chunked and unchunked from the
same ``torch.Generator`` seed; and a solve and ``om_cost_grid`` on that
model match the reference's at the tolerances of
``tests/test_torch_estimator.py`` and ``tests/test_torch_core.py``.

A constant Q is the other case: the estimator's OM cost takes its
pseudo-inverse once a solve instead of on every grid point, and the
cost of a stacked solve still matches the reference's ``om_cost_grid``
record by record, with and without a mask and a prior.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wiener_velocity import WienerVelocityConfig as JWiener
from repro.core import Estimator as JEstimator
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import sde as jsde
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.configs.wiener_velocity import WienerVelocityConfig
from repro_torch.core import (
    Estimator,
    KernelOptions,
    ParallelOptions,
    Problem,
)
from repro_torch import obs
from repro_torch.core import sde as tsde

torch.set_num_threads(1)

N = 300            # grid intervals: 5 chunks of CHUNK on one record
CHUNK = 64
NSUB = 5
RECORDS = 3
METHODS = {
    "parallel_kernel": KernelOptions(nsub=NSUB, mode="discrete"),
    "parallel_rts": ParallelOptions(nsub=NSUB, mode="discrete"),
}


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(tsde, "EIGH_CHUNK", CHUNK)


def _scale_t(t):
    return 1.0 + 0.5 * torch.sin(t)


def _wiener_tv():
    """The port's Wiener velocity model with ``Q(t) = Q (1 + 0.5 sin t)``
    and the reference's, from the same constants."""
    tmodel = WienerVelocityConfig().model()
    jmodel = JWiener().model()
    Q, jQ = tmodel.Q, jmodel.Q
    np.testing.assert_array_equal(Q.numpy(), np.asarray(jQ))
    return (dataclasses.replace(tmodel, Q=lambda t: Q * _scale_t(t)),
            dataclasses.replace(jmodel,
                                Q=lambda t: jQ * (1.0 + 0.5 * jnp.sin(t))))


def _ct_tv():
    """The coordinated-turn model (section 5.2) with a callable Q and R."""
    model = CoordinatedTurnConfig().model()
    Q, R = model.Q, model.R
    return dataclasses.replace(
        model, Q=lambda t: Q * _scale_t(t),
        R=lambda t: R * (1.0 + 0.25 * torch.cos(t)))


def _stacked_grid(T: float = 6.0):
    """``(N + 1, RECORDS)`` time grids with distinct end times."""
    return torch.stack([tsde.time_grid(0.0, T + r, N)
                        for r in range(RECORDS)], dim=1)


def test_chunked_psd_sqrt_matches_reference(chunked):
    """The square roots of a singular, time-varying Q over RECORDS x N grid
    points (15 chunks) against the reference's ``_psd_sqrt``, matrix by
    matrix."""
    tmodel, jmodel = _wiener_tv()
    ts = _stacked_grid()
    Qgrid = tmodel._eval(tmodel.Q, ts[:-1])
    assert Qgrid.shape == (N, RECORDS, 4, 4)
    assert Qgrid.shape[0] * Qgrid.shape[1] > 10 * CHUNK
    got = tsde._psd_sqrt(Qgrid)
    flat = jnp.asarray(Qgrid.reshape(-1, 4, 4).numpy())
    want = np.asarray(jax.vmap(jsde._psd_sqrt)(flat)).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))
    # Q stays singular: two zero eigenvalues at every grid point
    assert float(torch.linalg.eigvalsh(Qgrid)[..., :2].abs().max()) == 0.0


def test_psd_sqrt_drives_no_null_direction():
    """A singular Q that is not diagonal (random rotations of the Wiener
    model's diag(0, 0, q, q)): eigh returns its null eigenvalues as
    round-off, which ``_psd_sqrt`` counts as zero (the pseudo-inverse's
    cutoff), so the factor has no component along Q's null space and
    squares back to Q; ``sqrt(max(w, 0))`` of the same eigenvalues puts
    ~1e-8 of the factor there."""
    gen = torch.Generator().manual_seed(7)
    rot = torch.linalg.qr(torch.randn((CHUNK, 4, 4), generator=gen,
                                      dtype=torch.float64))[0]
    diag = torch.tensor([0.0, 0.0, 4.0, 6.0], dtype=torch.float64)
    Q = rot @ torch.diag_embed(diag.expand(CHUNK, 4)) @ rot.mT
    Q = 0.5 * (Q + Q.mT)
    null = rot[..., :2]
    S = tsde._psd_sqrt(Q)
    scale = float(S.abs().max())
    assert float((S @ null).abs().max()) < 1e-13 * scale
    assert float((S @ S - Q).abs().max()) < 1e-13 * float(Q.abs().max())
    w, V = torch.linalg.eigh(Q)
    assert float(w[..., :2].abs().max()) > 0.0       # round-off, not zero
    plain = (V * w.clamp(min=0.0).sqrt().unsqueeze(-2)) @ V.mT
    assert float((plain @ null).abs().max()) > 1e-10 * scale


@pytest.mark.parametrize("kind", ["linear", "nonlinear"])
def test_simulate_is_bit_identical_chunked_and_unchunked(monkeypatch, kind):
    """Callable Q and R: the square roots in chunks give the unchunked
    run's bits, draw for draw, from the same generator seed."""
    if kind == "linear":
        model = _wiener_tv()[0]
        model = dataclasses.replace(
            model, R=lambda t, R=model.R: R * (1.0 + 0.25 * torch.cos(t)))
        simulate = tsde.simulate_linear
    else:
        model = _ct_tv()
        simulate = tsde.simulate_nonlinear
    ts = _stacked_grid(3.0)
    runs = []
    for chunk in (CHUNK, N * RECORDS):
        monkeypatch.setattr(tsde, "EIGH_CHUNK", chunk)
        runs.append(simulate(model, ts, torch.Generator().manual_seed(5)))
    (xa, ya), (xb, yb) = runs
    assert xa.shape == (N + 1, RECORDS, model.nx)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert bool(torch.isfinite(ya).all())


@pytest.fixture(scope="module")
def wiener_tv_record():
    """One record of the time-varying Wiener model simulated by the
    reference (so both packages see the same measurements)."""
    tmodel, jmodel = _wiener_tv()
    ts = jsde.time_grid(0.0, 6.0, N)
    _, y = jsde.simulate_linear(jmodel, ts, jax.random.PRNGKey(3))
    return tmodel, jmodel, np.array(ts), np.array(y)


@pytest.mark.parametrize("method", list(METHODS))
def test_solve_with_time_varying_q_matches_reference(wiener_tv_record,
                                                     method):
    """``Estimator.solve`` on the time-varying-Q record against the
    reference's ``parallel_rts``: max|dx| < 1e-8, S/v rtol 1e-9 atol 1e-8,
    the cost (the pseudo-inverse of each singular Q(t)) rtol 1e-9."""
    tmodel, jmodel, ts, y = wiener_tv_record
    ref = JEstimator(jmodel, method="parallel_rts",
                     options=JParallelOptions(nsub=NSUB, mode="discrete")
                     ).solve(JProblem.single(jmodel, ts, y))
    got = Estimator(tmodel, method=method, options=METHODS[method],
                    device="cpu").solve(Problem.single(tmodel, ts, y))
    assert float(np.max(np.abs(got.x.numpy() - np.asarray(ref.x)))) < 1e-8
    np.testing.assert_allclose(got.S.numpy(), np.asarray(ref.S),
                               rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v),
                               rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9, atol=1e-8)


def test_om_cost_grid_with_time_varying_q_matches_reference(
        wiener_tv_record):
    """``om_cost_grid`` (the pseudo-inverse of each singular Q(t)) off the
    optimum against the reference's at rtol 1e-10."""
    tmodel, jmodel, ts, y = wiener_tv_record
    jgrid = jsde.grid_lqt_from_linear(jmodel, jnp.asarray(ts), jnp.asarray(y))
    tgrid = tsde.grid_lqt_from_linear(tmodel, torch.as_tensor(ts),
                                      torch.as_tensor(y))
    x = np.array(jsde.simulate_linear(jmodel, jnp.asarray(ts),
                                      jax.random.PRNGKey(4))[0])
    np.testing.assert_allclose(
        tsde.om_cost_grid(tgrid, torch.as_tensor(x)).numpy(),
        np.asarray(jsde.om_cost_grid(jgrid, jnp.asarray(x))),
        rtol=1e-10, atol=1e-12)


def _stacked_wiener_problem(tmodel, masked, with_prior):
    """RECORDS Wiener records of N intervals (distinct end times) from the
    port's simulator, with an optional mask (about a quarter of the
    intervals unobserved) and an optional shared information-form prior;
    the port's stacked problem and the same arrays in NumPy."""
    ts = _stacked_grid(3.0)
    _, y = tsde.simulate_linear(tmodel, ts, torch.Generator().manual_seed(9))
    arrays = dict(ts=ts.T.numpy(), y=y.movedim(1, 0).numpy(), mask=None,
                  prior=None)
    if masked:
        keep = np.random.default_rng(2).random((RECORDS, N)) > 0.25
        arrays["mask"] = keep.astype(np.float64)
    if with_prior:
        S0 = np.diag([50.0, 80.0, 20.0, 30.0]) + 5.0
        arrays["prior"] = (S0, S0 @ np.array([4.0, 6.0, 0.5, -0.5]))
    problem = Problem.stacked(tmodel, arrays["ts"], arrays["y"],
                              measurement_mask=arrays["mask"],
                              prior=arrays["prior"])
    return problem, arrays


@pytest.mark.parametrize("with_prior", [False, True], ids=["m0P0", "prior"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("q_jitter", [0.0, 0.3], ids=["singular", "regular"])
def test_stacked_cost_with_constant_q_matches_reference(q_jitter, masked,
                                                        with_prior):
    """``Estimator(diagnostics=True)`` on a stacked batch of RECORDS
    Wiener records with a constant Q, singular (``q_jitter = 0``) or not:
    each record's ``Solution.cost`` (Q's pseudo-inverse taken once) equals
    the reference's ``om_cost_grid`` on its own grid at the port's
    trajectory, rtol 1e-10, atol 1e-12."""
    tmodel = WienerVelocityConfig(q_jitter=q_jitter).model()
    jmodel = JWiener(q_jitter=q_jitter).model()
    problem, a = _stacked_wiener_problem(tmodel, masked, with_prior)
    sol = Estimator(tmodel, method="parallel_kernel",
                    options=METHODS["parallel_kernel"], device="cpu",
                    diagnostics=True).solve(problem)
    assert sol.cost.shape == (RECORDS,)
    jprior = None if a["prior"] is None else tuple(map(jnp.asarray,
                                                      a["prior"]))
    want = []
    for r in range(RECORDS):
        jgrid = jsde.grid_lqt_from_linear(
            jmodel, jnp.asarray(a["ts"][r]), jnp.asarray(a["y"][r]),
            measurement_mask=(None if a["mask"] is None
                              else jnp.asarray(a["mask"][r])),
            prior=jprior)
        want.append(float(jsde.om_cost_grid(jgrid,
                                            jnp.asarray(sol.x[r].numpy()))))
    np.testing.assert_allclose(sol.cost.numpy(), np.array(want),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["constant", "callable"])
def test_cost_factors_constant_q_once_and_callable_q_per_point(
        monkeypatch, kind):
    """The batch shapes ``torch.linalg.pinv`` sees in one stacked solve
    with telemetry on: a constant Q is factored as one matrix
    (``cost.qpinv.once`` reads 1), a callable Q on every grid point of
    every record (``cost.qpinv.grid`` reads 1)."""
    tmodel = WienerVelocityConfig().model()
    if kind == "callable":
        tmodel = _wiener_tv()[0]
    shapes = []
    pinv = torch.linalg.pinv

    def recording_pinv(A, *args, **kwargs):
        shapes.append(tuple(A.shape[:-2]))
        return pinv(A, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "pinv", recording_pinv)
    problem, _ = _stacked_wiener_problem(tmodel, False, False)
    est = Estimator(tmodel, method="parallel_kernel",
                    options=METHODS["parallel_kernel"], device="cpu",
                    diagnostics=True)
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        sol = est.solve(problem)
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
        (obs.enable if was else obs.disable)()
    assert bool(torch.isfinite(sol.cost).all())
    used, unused = (("cost.qpinv.once", "cost.qpinv.grid")
                    if kind == "constant" else
                    ("cost.qpinv.grid", "cost.qpinv.once"))
    assert shapes == ([()] if kind == "constant" else [(N, RECORDS)])
    assert counters[used] == 1 and unused not in counters
