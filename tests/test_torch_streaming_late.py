"""Late and out-of-order data and adaptive lag in the PyTorch port's
``StreamingEngine``: the merge helpers equal to the reference's exactly,
the reference's ``tests/test_streaming_late.py`` cases on the port, and
the adaptive lag following the same trajectory as the reference engine's
on the same pushes.

Measurements are simulated by the reference and fed to both packages.
Tolerances are the reference tests' own: windows re-solved after a late
merge equal the offline MAP at 1e-9 x scale (linear), 1e-6 (Taylor) and
1e-5 (sigma point).
"""
import gc

import jax
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro import obs as jobs
from repro.core import clear_cache as jclear_cache
from repro.core import ParallelOptions as JParallelOptions
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro.serving import StreamingEngine as JStreamingEngine
from repro.serving.waves import insert_warm_states as jinsert_warm_states
from repro.serving.waves import merge_measurements as jmerge_measurements
from repro_torch import obs
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    ParallelOptions,
    Problem,
)
from repro_torch.serving import StreamingEngine
from repro_torch.serving.waves import (
    insert_warm_states,
    merge_measurements,
    robust_default_options,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB = 5
OPTIONS = ParallelOptions(nsub=NSUB, mode="discrete")


@pytest.fixture(autouse=True)
def _clean_obs():
    was = (obs.enabled(), jobs.enabled())
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o, w in zip((obs, jobs), was):
        o.reset()
        (o.enable if w else o.disable)()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()


def _port_linear(jmodel):
    return linear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k))
         for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")})


def _port_ct(jmodel):
    ref = CoordinatedTurnConfig().model()
    return nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)


_WIENER = _port_linear(wiener_velocity())
_CT = _port_ct(coordinated_turn())


def _linear_data(N, seed=0, T=None):
    ts = time_grid(0.0, (N / 10.0) if T is None else T, N)
    _, y = jsimulate_linear(wiener_velocity(), ts, jax.random.PRNGKey(seed))
    return _WIENER, np.asarray(ts), np.asarray(y)


def _ct_data(N, T, seed):
    ts = time_grid(0.0, T, N)
    _, y = jsimulate_nonlinear(coordinated_turn(), ts,
                               jax.random.PRNGKey(seed))
    return _CT, np.asarray(ts), np.asarray(y)


def _engine(model, **kw):
    kw.setdefault("device", "cpu")
    return StreamingEngine(model, **kw)


def _offline(model, ts, y, options=OPTIONS, method="parallel_rts"):
    return Estimator(model, method=method, options=options,
                     device="cpu").solve(Problem.single(model, ts, y)).x.numpy()


def _same_merge(a, b):
    for f in ("ts", "y", "positions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("appended", "merged", "replaced", "dropped_late",
              "dropped_duplicates"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.changed == b.changed


# -- merge helpers: equal to the reference's -------------------------------


@pytest.mark.parametrize("case", [
    "classification", "fresh", "replace", "drop", "random"])
def test_merge_measurements_equals_reference(case):
    ts = np.array([0.0, 1.0, 2.0, 3.0])
    y = np.array([[1.0], [2.0], [3.0]])
    policy = "error"
    if case == "classification":
        ts_new = np.array([-1.0, 0.0, 1.5, 4.0])
        y_new = np.array([[9.0], [9.0], [1.5], [4.0]])
    elif case == "fresh":
        ts, y = np.array([0.0]), None
        ts_new, y_new = np.array([1.0, 2.0]), np.array([[1.0], [2.0]])
    elif case in ("replace", "drop"):
        policy = case
        ts_new, y_new = np.array([1.0, 2.5, 3.0]), np.array([[7.0], [8.0],
                                                             [9.0]])
    else:
        rng = np.random.default_rng(3)
        ts = np.concatenate([[0.0], np.sort(rng.uniform(0, 10, 30))])
        y = rng.standard_normal((30, 2))
        ts_new = np.sort(np.concatenate([rng.uniform(-2, 12, 20),
                                         ts[rng.choice(30, 4) + 1]]))
        y_new = rng.standard_normal((24, 2))
        policy = "replace"
    y_before = None if y is None else y.copy()
    got = merge_measurements(ts, y, ts_new, y_new, duplicate=policy)
    want = jmerge_measurements(ts, y, ts_new, y_new, duplicate=policy)
    _same_merge(got, want)
    if y is not None:
        np.testing.assert_array_equal(y, y_before)   # never in place


def test_merge_measurements_errors_match_reference():
    ts, y = np.array([0.0, 1.0, 2.0]), np.array([[1.0], [2.0]])
    for fn in (merge_measurements, jmerge_measurements):
        with pytest.raises(ValueError, match="duplicate"):
            fn(ts, y, np.array([1.0]), np.array([[7.0]]))
        with pytest.raises(ValueError, match="duplicate policy"):
            fn(ts, y, np.array([1.0]), np.array([[7.0]]),
               duplicate="overwrite")


@pytest.mark.parametrize("positions", [[1, 2], [5], [0, 0, 3], []])
def test_insert_warm_states_equals_reference(positions):
    xw = np.arange(8.0).reshape(4, 2)
    pos = np.array(positions, dtype=int)
    np.testing.assert_array_equal(insert_warm_states(xw, pos),
                                  jinsert_warm_states(xw, pos))


# -- window-rewind exactness ----------------------------------------------


def test_late_in_window_push_matches_offline_linear():
    model, ts, y = _linear_data(40)
    ref = _offline(model, ts, y)
    scale = np.max(np.abs(ref))
    lag = 15
    eng = _engine(model, lag=lag, batch=4, options=OPTIONS)
    tid = eng.open_track(ts[0])
    mask = np.ones(40, bool)
    mask[[30, 33, 35]] = False
    eng.push(tid, ts[1:][mask], y[mask])
    eng.run()
    summary = eng.push(tid, ts[1:][~mask], y[~mask])
    assert summary == {"appended": 0, "merged": 3, "replaced": 0,
                       "dropped_late": 0, "dropped_duplicates": 0}
    eng.run()
    full = eng.estimate(tid).x.numpy()
    assert full.shape == ref.shape
    np.testing.assert_allclose(full[-lag - 1:], ref[-lag - 1:], rtol=0,
                               atol=1e-9 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_shuffled_pushes_equal_in_order(seed):
    model, ts, y = _linear_data(20, seed=3)
    order = np.random.default_rng(seed).permutation(20)
    eng_in = _engine(model, lag=30, batch=2, options=OPTIONS)
    eng_sh = _engine(model, lag=30, batch=2, options=OPTIONS)
    t_in, t_sh = eng_in.open_track(ts[0]), eng_sh.open_track(ts[0])
    for n, i in enumerate(range(20)):
        eng_in.push(t_in, ts[i + 1:i + 2], y[i:i + 1])
        j = order[i]
        eng_sh.push(t_sh, ts[j + 1:j + 2], y[j:j + 1])
        if n % 6 == 5:
            eng_in.run()
            eng_sh.run()
    a = eng_in.estimate(t_in).x.numpy()
    b = eng_sh.estimate(t_sh).x.numpy()
    scale = np.max(np.abs(a))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(a, _offline(model, ts, y), rtol=0,
                               atol=1e-9 * scale)


def test_late_in_window_push_matches_offline_nonlinear():
    model, ts, y = _ct_data(30, 3.0, 2)
    opts = IteratedOptions(iterations=12, inner=OPTIONS)
    ref = _offline(model, ts, y, options=opts)
    eng = _engine(model, lag=64, batch=2, options=opts)
    tid = eng.open_track(ts[0])
    mask = np.ones(30, bool)
    mask[[20, 24]] = False
    eng.push(tid, ts[1:][mask], y[mask])
    eng.run()
    assert eng.push(tid, ts[1:][~mask], y[~mask])["merged"] == 2
    eng.run()
    full = eng.estimate(tid).x.numpy()
    np.testing.assert_allclose(full, ref, rtol=0,
                               atol=1e-6 * np.max(np.abs(ref)))


def test_late_in_window_push_matches_offline_sigma_point():
    model, ts, y = _ct_data(20, 2.0, 5)
    opts = robust_default_options("sigma_point").replace(iterations=12)
    ref = _offline(model, ts, y, options=opts, method="sigma_point")
    eng = _engine(model, lag=64, batch=2, method="sigma_point",
                  options=opts)
    tid = eng.open_track(ts[0])
    mask = np.ones(20, bool)
    mask[[12, 15]] = False
    eng.push(tid, ts[1:][mask], y[mask])
    eng.run()
    assert eng.push(tid, ts[1:][~mask], y[~mask])["merged"] == 2
    eng.run()
    full = eng.estimate(tid).x.numpy()
    np.testing.assert_allclose(full, ref, rtol=0,
                               atol=1e-5 * np.max(np.abs(ref)))


# -- mid-solve races -------------------------------------------------------


def test_mid_solve_merge_into_evicted_region_is_not_lost():
    """A merge into the about-to-be-evicted region while a solve is in
    flight defers that eviction to the re-solve the merge queued."""
    model, ts, y = _linear_data(40)
    lag = 8
    obs.enable()
    eng = _engine(model, lag=lag, batch=1, options=OPTIONS)
    tid = eng.open_track(ts[0])
    hold = 28
    mask = np.ones(40, bool)
    mask[hold] = False
    eng.push(tid, ts[1:33][mask[:32]], y[:32][mask[:32]])
    eng.run()
    eng.push(tid, ts[33:], y[32:])
    real_solve = eng.estimator.solve
    raced = []

    def racing_solve(problem):
        sol = real_solve(problem)
        if not raced:
            raced.append(eng.push(tid, ts[hold + 1:hold + 2],
                                  y[hold:hold + 1]))
        return sol

    eng.estimator.solve = racing_solve
    try:
        eng.step()
    finally:
        eng.estimator.solve = real_solve
    assert raced and raced[0]["merged"] == 1
    assert eng.due() == 1
    assert obs.snapshot()["counters"]["stream.deferred_evictions"] == 1
    eng.run()
    ref = _offline(model, ts, y)
    full = eng.estimate(tid).x.numpy()
    assert full.shape == ref.shape
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(full[-lag - 1:], ref[-lag - 1:], rtol=0,
                               atol=1e-9 * scale)
    track = eng._tracks[tid]
    assert track.y.shape[0] == lag
    assert track.ts[0] == ts[40 - lag]


def test_evict_residual_matches_rows_by_timestamp():
    model, ts, y = _linear_data(40)
    eng = _engine(model, lag=8, batch=1, options=OPTIONS)
    tid = eng.open_track(ts[0])
    hold = 16
    mask = np.ones(24, bool)
    mask[hold] = False
    eng.push(tid, ts[1:25][mask], y[:24][mask])
    eng.run()
    prev_ts = eng._tracks[tid].ts.copy()
    prev_x = eng.window(tid).x.numpy()
    eng.push(tid, ts[hold + 1:hold + 2], y[hold:hold + 1])
    eng.push(tid, ts[25:29], y[24:28])
    eng.run()
    committed = eng.committed(tid).x.numpy()
    assert committed.shape[0] == 20
    prev_index = {t: i for i, t in enumerate(prev_ts)}
    expected = max(
        float(np.max(np.abs(committed[15 + i] - prev_x[prev_index[t]])))
        for i, t in enumerate(ts[15:20]) if t in prev_index)
    assert ts[17] not in prev_index
    assert eng._tracks[tid].last_evict_delta == pytest.approx(
        expected, rel=1e-12)


# -- committed-horizon drops and the reorder buffer ------------------------


def test_too_late_push_is_dropped_and_counted():
    model, ts, y = _linear_data(30)
    obs.enable()
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    eng.push(tid, ts[1:], y)
    eng.run()
    before = eng.estimate(tid).x
    summary = eng.push(tid, ts[3:5], y[2:4])
    assert summary["dropped_late"] == 2
    assert eng.due() == 0
    assert torch.equal(eng.estimate(tid).x, before)
    snap = obs.snapshot()
    assert snap["counters"]["stream.late_drops"] == 2
    assert "stream.late_merges" not in snap["counters"]


def test_reorder_slack_delays_eviction_so_near_late_data_merges():
    model, ts, y = _linear_data(40)
    lag, slack = 8, 6
    hold = 20
    mask = np.ones(40, bool)
    mask[hold] = False

    def run_engine(s):
        eng = _engine(model, lag=lag, batch=2, options=OPTIONS,
                      reorder_slack=s)
        tid = eng.open_track(ts[0])
        eng.push(tid, ts[1:33][mask[:32]], y[:32][mask[:32]])
        eng.run()
        summary = eng.push(tid, ts[hold + 1:hold + 2], y[hold:hold + 1])
        eng.push(tid, ts[33:], y[32:])
        eng.run()
        return eng, tid, summary

    eng0, t0, s0 = run_engine(0)
    assert s0 == {"appended": 0, "merged": 0, "replaced": 0,
                  "dropped_late": 1, "dropped_duplicates": 0}
    eng1, t1, s1 = run_engine(slack)
    assert s1["merged"] == 1 and s1["dropped_late"] == 0
    assert eng1._tracks[t1].y.shape[0] == lag + slack
    ref = _offline(model, ts, y)
    scale = np.max(np.abs(ref))
    got = eng1.estimate(t1).x.numpy()
    np.testing.assert_allclose(got[-(lag + slack) - 1:],
                               ref[-(lag + slack) - 1:], rtol=0,
                               atol=1e-9 * scale)
    got0 = eng0.estimate(t0).x.numpy()
    assert got0.shape[0] == 40
    assert np.max(np.abs(got0 - np.delete(ref, hold + 1, axis=0))) \
        > 1e-6 * scale


def test_duplicate_policies_through_the_engine():
    model, ts, y = _linear_data(10)
    y2 = y.copy()
    y2[5] += 2.5
    eng = _engine(model, lag=20, batch=2, options=OPTIONS,
                  duplicate_policy="replace")
    tid = eng.open_track(ts[0])
    eng.push(tid, ts[1:], y)
    eng.run()
    summary = eng.push(tid, ts[6:7], y2[5:6])
    assert summary["replaced"] == 1 and eng.due() == 1
    eng.run()
    np.testing.assert_allclose(eng.estimate(tid).x.numpy(),
                               _offline(model, ts, y2), rtol=0,
                               atol=1e-9 * np.max(np.abs(y2)))
    eng_d = _engine(model, lag=20, batch=2, options=OPTIONS,
                    duplicate_policy="drop")
    td = eng_d.open_track(ts[0])
    eng_d.push(td, ts[1:], y)
    eng_d.run()
    summary = eng_d.push(td, ts[6:7], y2[5:6])
    assert summary["dropped_duplicates"] == 1 and eng_d.due() == 0
    np.testing.assert_allclose(eng_d.estimate(td).x.numpy(),
                               _offline(model, ts, y), rtol=0,
                               atol=1e-9 * np.max(np.abs(y)))


def _late_obs_pushes(eng, ts, y):
    tid = eng.open_track(float(ts[0]))
    mask = np.ones(30, bool)
    mask[[24, 27]] = False
    eng.push(tid, ts[1:][mask], y[mask])
    eng.run()
    eng.push(tid, ts[1:][~mask], y[~mask])   # in-window late
    eng.push(tid, ts[26:27], y[25:26])       # duplicate -> dropped
    eng.push(tid, ts[2:3], y[1:2])           # behind horizon -> dropped
    eng.run()
    return tid


def test_late_obs_taxonomy_matches_reference():
    """The reference's ``test_late_obs_taxonomy`` on both engines: the
    same ``stream.*`` counters, and the same final window."""
    _, ts, y = _linear_data(30)
    snaps, xs = [], []
    for pkg, eng in (
            (jobs, JStreamingEngine(
                wiener_velocity(), lag=10, batch=2, duplicate_policy="drop",
                options=JParallelOptions(nsub=NSUB, mode="discrete"))),
            (obs, _engine(_WIENER, lag=10, batch=2, options=OPTIONS,
                          duplicate_policy="drop"))):
        pkg.reset()
        pkg.enable()
        tid = _late_obs_pushes(eng, ts, y)
        snaps.append(pkg.snapshot()["counters"])
        xs.append(np.asarray(eng.estimate(tid).x))
        pkg.disable()
    ref, got = snaps
    assert got["stream.late_merges"] == 2
    assert got["stream.duplicates_dropped"] == 1
    assert got["stream.late_drops"] == 1
    assert got["stream.pushed_intervals"] == 30
    for name, value in ref.items():
        if name.startswith("stream."):
            assert got[name] == value, name
    np.testing.assert_allclose(xs[1], xs[0], rtol=0,
                               atol=1e-9 * np.max(np.abs(xs[0])))


# -- adaptive lag ----------------------------------------------------------


def test_adaptive_lag_grows_shrinks_and_respects_bounds():
    model, ts, y = _linear_data(60)
    obs.enable()
    tight = _engine(model, lag=4, batch=1, options=OPTIONS,
                    committed_error_target=1e-12, lag_min=2, lag_max=12)
    tid = tight.open_track(ts[0])
    for i in range(0, 60, 4):
        tight.push(tid, ts[i + 1:i + 5], y[i:i + 4])
        tight.run()
    assert tight.lag == 12
    assert tight.lag_adjustments >= 8
    snap = obs.snapshot()
    assert snap["counters"]["stream.lag_adjustments"] == \
        tight.lag_adjustments
    assert snap["gauges"]["stream.lag"] == 12
    assert "stream.evict_delta" in snap["histograms"]

    loose = _engine(model, lag=10, batch=1, options=OPTIONS,
                    committed_error_target=1e6, lag_min=3, lag_max=12)
    tid = loose.open_track(ts[0])
    for i in range(0, 60, 4):
        loose.push(tid, ts[i + 1:i + 5], y[i:i + 4])
        loose.run()
    assert loose.lag == 3


def _fixed_lag_residual_curve(model, ts, y, chunk, lags):
    """The committed-error proxy the engine steers on, computed offline
    (the reference test's helper, on the port's ragged solve)."""
    N = y.shape[0]
    ends = list(range(chunk, N + 1, chunk))
    est = Estimator(model, options=OPTIONS, device="cpu")
    sols = est.solve(Problem.ragged(
        model, [(ts[:m + 1], y[:m]) for m in ends]))
    xs = {m: s.x.numpy()[:m + 1] for m, s in zip(ends, sols)}
    curve = {}
    for lag in lags:
        deltas = []
        for m_prev, m in zip(ends[:-1], ends[1:]):
            for k in range(max(0, m_prev - lag), m - lag):
                if 0 <= k <= m_prev:
                    deltas.append(np.max(np.abs(xs[m][k] - xs[m_prev][k])))
        curve[lag] = float(np.max(deltas[len(deltas) // 4:]))
    return curve


def _lag_trajectory(eng, ts, y, chunk):
    tid = eng.open_track(float(ts[0]))
    lags = []
    for i in range(0, y.shape[0], chunk):
        eng.push(tid, ts[i + 1:i + 1 + chunk], y[i:i + chunk])
        eng.run()
        lags.append(eng.lag)
    return lags


@pytest.fixture(scope="module")
def adaptive_workload():
    """The reference test's workload, its target, and the reference
    engine's lag after every round from below and from above."""
    model, ts, y = _linear_data(120, seed=4)
    chunk = 4
    lags = range(3, 25)
    curve = _fixed_lag_residual_curve(model, ts, y, chunk, lags)
    target = float(np.sqrt(curve[8] * curve[16]))
    ref = {start: _lag_trajectory(
        JStreamingEngine(wiener_velocity(), lag=start, batch=1,
                         options=JParallelOptions(nsub=NSUB,
                                                  mode="discrete"),
                         committed_error_target=target, lag_min=2,
                         lag_max=40), ts, y, chunk) for start in (3, 24)}
    return dict(ts=ts, y=y, chunk=chunk, lags=lags, curve=curve,
                target=target, ref=ref)


@pytest.mark.parametrize("start", [3, 24])
def test_adaptive_lag_trajectory_matches_reference(adaptive_workload, start):
    w = adaptive_workload
    eng = _engine(_WIENER, lag=start, batch=1, options=OPTIONS,
                  committed_error_target=w["target"], lag_min=2, lag_max=40)
    assert _lag_trajectory(eng, w["ts"], w["y"], w["chunk"]) == \
        w["ref"][start]


def test_adaptive_lag_converges_to_smallest_sufficient_fixed_lag(
        adaptive_workload):
    w = adaptive_workload
    l_star = min(L for L in w["lags"] if w["curve"][L] <= w["target"])
    assert 4 < l_star < 22, f"degenerate workload: L*={l_star}"
    for start in (3, 24):
        eng = _engine(_WIENER, lag=start, batch=1, options=OPTIONS,
                      committed_error_target=w["target"], lag_min=2,
                      lag_max=40)
        final = _lag_trajectory(eng, w["ts"], w["y"], w["chunk"])[-1]
        assert abs(final - l_star) <= 2, (start, final, l_star)


def test_adaptive_lag_estimates_stay_exact():
    model, ts, y = _linear_data(80, seed=6)
    eng = _engine(model, lag=6, batch=2, options=OPTIONS,
                  committed_error_target=1e-3, lag_min=2, lag_max=30)
    tid = eng.open_track(ts[0])
    for i in range(0, 80, 5):
        eng.push(tid, ts[i + 1:i + 6], y[i:i + 5])
        eng.run()
    ref = _offline(model, ts, y)
    scale = np.max(np.abs(ref))
    full = eng.estimate(tid).x.numpy()
    assert full.shape == ref.shape
    win = eng.window(tid).x.shape[0]
    np.testing.assert_allclose(full[-win:], ref[-win:], rtol=0,
                               atol=1e-9 * scale)
    assert np.max(np.abs(full - ref)) / scale < 0.05
