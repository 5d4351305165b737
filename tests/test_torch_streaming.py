"""The PyTorch port's ``StreamingEngine``, held against the JAX
reference's on the same push sequences, and the reference's
``tests/test_streaming_engine.py`` cases (threaded ones included) on the
port.

Both engines get the same numpy measurements, simulated by the reference.
Tolerances: linear windows equal to the reference engine's at 1e-9 x
scale, nonlinear ones (Taylor and sigma point, iterated) at 1e-6 x scale;
the lag, committed lengths and ``stream.*`` counters exactly.  The port's
cases keep the reference tests' own bounds against the port's offline
solves.
"""
import gc
import threading
import time

import jax
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro import obs as jobs
from repro.core import clear_cache as jclear_cache
from repro.core import IteratedOptions as JIteratedOptions
from repro.core import ParallelOptions as JParallelOptions
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro.serving import StreamingEngine as JStreamingEngine
from repro_torch import obs
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    Problem,
    SigmaPointOptions,
)
from repro_torch.serving import StreamingEngine
from repro_torch.serving.waves import robust_default_options

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB = 5
OPTIONS = ParallelOptions(nsub=NSUB, mode="discrete")
# the stream.* counters both engines must agree on exactly
STREAM_COUNTERS = ("tracks_opened", "pushes", "pushed_intervals", "waves",
                   "completed", "recycled_rows", "real_intervals",
                   "padded_intervals", "evicted_intervals")


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


def _stream(eng, tid, ts, y, chunk):
    """Push (ts, y) in ``chunk``-interval pieces, draining after each."""
    N = y.shape[0]
    i = 0
    while i < N:
        k = min(chunk, N - i)
        eng.push(tid, ts[i + 1:i + 1 + k], y[i:i + k])
        i += k
        eng.run()


# -- parity with the reference engine -----------------------------------------


def _scenario(name):
    """(port model, port engine kwargs, reference engine kwargs, data per
    track, chunk, tolerance) of one parity scenario."""
    if name == "linear":
        _, ts, y0 = _linear_data(60, seed=0)
        _, _, y1 = _linear_data(60, seed=1)
        return (_WIENER, dict(lag=15, batch=4, options=OPTIONS),
                dict(lag=15, batch=4,
                     options=JParallelOptions(nsub=NSUB, mode="discrete")),
                [(ts, y0), (ts, y1)], 7, 1e-9)
    if name == "taylor":
        _, ts, y = _ct_data(30, 3.0, 2)
        return (_CT, dict(lag=10, batch=2, options=IteratedOptions(
                    iterations=5, inner=OPTIONS)),
                dict(lag=10, batch=2, options=JIteratedOptions(
                    iterations=5, inner=JParallelOptions(nsub=NSUB,
                                                         mode="discrete"))),
                [(ts, y)], 10, 1e-6)
    # the reference's tests/test_linearize.py::
    # test_streaming_engine_sigma_point: robust defaults, 40 intervals
    _, ts, y = _ct_data(200, 5.0, 2)
    return (_CT, dict(lag=8, batch=2, method="sigma_point"),
            dict(lag=8, batch=2, method="sigma_point"),
            [(ts[:41], y[:40])], 40, 1e-6)


@pytest.fixture(scope="module")
def reference_streams():
    """Each scenario streamed once through the reference engine with its
    obs enabled: the final estimates, lag, committed lengths, counters."""
    out = {}
    was = jobs.enabled()
    try:
        for name in ("linear", "taylor", "sigma_point"):
            _, _, kw, data, chunk, _ = _scenario(name)
            jobs.reset()
            jobs.enable()
            eng = JStreamingEngine(coordinated_turn() if name != "linear"
                                   else wiener_velocity(), **kw)
            tids = [eng.open_track(float(ts[0])) for ts, _ in data]
            for tid, (ts, y) in zip(tids, data):
                _stream(eng, tid, ts, y, chunk)
            out[name] = _readout(eng, tids, jobs.snapshot(), np.asarray)
    finally:
        jobs.reset()
        (jobs.enable if was else jobs.disable)()
    return out


def _readout(eng, tids, snap, host):
    est = [eng.estimate(t) for t in tids]
    committed = [eng.committed(t) for t in tids]
    return dict(
        x=[host(s.x) for s in est], S=[host(s.S) for s in est],
        v=[host(s.v) for s in est],
        committed=[0 if c is None else c.x.shape[0] for c in committed],
        window=[eng.window(t).x.shape[0] for t in tids],
        lag=eng.lag, waves=eng.waves, evicted=eng.evicted_intervals,
        counters=snap["counters"])


@pytest.mark.parametrize("name,method", [
    ("linear", "parallel_rts"), ("linear", "parallel_kernel"),
    ("taylor", "parallel_rts"), ("sigma_point", "parallel_rts")])
def test_stream_matches_reference_engine(reference_streams, name, method):
    model, kw, _, data, chunk, tol = _scenario(name)
    if method == "parallel_kernel":
        kw = dict(kw, method="parallel_kernel",
                  options=KernelOptions(nsub=NSUB, mode="discrete"))
    obs.enable()
    eng = _engine(model, **kw)
    tids = [eng.open_track(float(ts[0])) for ts, _ in data]
    for tid, (ts, y) in zip(tids, data):
        _stream(eng, tid, ts, y, chunk)
    got = _readout(eng, tids, obs.snapshot(), lambda t: t.numpy())
    ref = reference_streams[name]
    for key in ("committed", "window", "lag", "waves", "evicted"):
        assert got[key] == ref[key], key
    for c in STREAM_COUNTERS:
        assert got["counters"].get(f"stream.{c}") == \
            ref["counters"].get(f"stream.{c}"), c
    for f in ("x", "S", "v"):
        for a, b in zip(got[f], ref[f]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.max(np.abs(b)))


def test_sigma_point_stream_defaults():
    """The reference's ``test_streaming_engine_sigma_point`` on the port:
    the robust default carries the sigma-point method with a discrete
    inner mode, and the windows come out finite."""
    opts = robust_default_options("sigma_point")
    assert isinstance(opts, SigmaPointOptions)
    assert opts.inner.mode == "discrete"
    model, ts, y = _ct_data(200, 5.0, 2)
    eng = _engine(model, lag=8, batch=2, method="sigma_point")
    tid = eng.open_track(float(ts[0]))
    eng.push(tid, ts[1:41], y[:40])
    eng.run()
    sol = eng.estimate(tid)
    assert tuple(sol.x.shape) == (41, model.nx)
    assert torch.isfinite(sol.x).all() and sol.x.device.type == "cpu"


# -- agreement with one-shot offline solves -------------------------------


def test_linear_window_agrees_with_offline_exactly():
    model, ts, y = _linear_data(60)
    ref = _offline(model, ts, y)
    eng = _engine(model, lag=15, batch=4, options=OPTIONS)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=7)
    full = eng.estimate(tid).x.numpy()
    assert full.shape == ref.shape
    scale = np.max(np.abs(ref))
    lag = eng.lag
    np.testing.assert_allclose(
        full[-lag - 1:], ref[-lag - 1:], rtol=0, atol=1e-9 * scale)


def test_linear_committed_state_is_truncated_offline_map():
    model, ts, y = _linear_data(40)
    est = Estimator(model, options=OPTIONS, device="cpu")
    lag = 10
    eng = _engine(model, lag=lag, batch=4, options=OPTIONS)
    tid = eng.open_track(ts[0])
    scale = np.max(np.abs(y))
    for j in range(1, y.shape[0] + 1):
        eng.push(tid, ts[j:j + 1], y[j - 1:j])
        eng.run()
        committed = eng.committed(tid)
        if committed is None:
            continue
        k = committed.x.shape[0] - 1
        off = est.solve(Problem.ragged(model, [(ts[:j + 1], y[:j])]))[0]
        np.testing.assert_allclose(
            committed.x[k].numpy(), off.x[k].numpy(), rtol=0,
            atol=1e-9 * scale)
        np.testing.assert_allclose(
            committed.S[k].numpy(), off.S[k].numpy(), rtol=0,
            atol=1e-9 * float(off.S.abs().max()))


def test_linear_fixed_lag_error_decays_with_lag():
    model, ts, y = _linear_data(60)
    ref = _offline(model, ts, y)
    scale = np.max(np.abs(ref))

    def stream_err(lag):
        eng = _engine(model, lag=lag, batch=4, options=OPTIONS)
        tid = eng.open_track(ts[0])
        _stream(eng, tid, ts, y, chunk=10)
        return np.max(np.abs(eng.estimate(tid).x.numpy() - ref)) / scale

    e_short, e_long = stream_err(5), stream_err(25)
    assert e_long < e_short
    assert e_long < 1e-3


def test_nonlinear_streaming_matches_offline():
    """Warm-started nonlinear streaming with the lag longer than the track
    agrees with the one-shot iterated offline solve (rtol 1e-6)."""
    model, ts, y = _ct_data(50, 5.0, 0)
    opts = IteratedOptions(iterations=12, inner=OPTIONS)
    ref = _offline(model, ts, y, options=opts)
    eng = _engine(model, lag=128, batch=4, options=opts)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=10)
    full = eng.estimate(tid).x.numpy()
    np.testing.assert_allclose(full, ref, rtol=0,
                               atol=1e-6 * np.max(np.abs(ref)))


def test_nonlinear_fixed_lag_window():
    model, ts, y = _ct_data(60, 6.0, 1)
    opts = IteratedOptions(iterations=8, inner=OPTIONS)
    ref = _offline(model, ts, y, options=opts)
    scale = np.max(np.abs(ref))

    def window_err(lag):
        eng = _engine(model, lag=lag, batch=4, options=opts)
        tid = eng.open_track(ts[0])
        _stream(eng, tid, ts, y, chunk=10)
        win = eng.estimate(tid).x.numpy()[-lag - 1:]
        return np.max(np.abs(win - ref[-lag - 1:])) / scale

    e_short, e_long = window_err(10), window_err(40)
    assert e_long < e_short
    assert e_long < 1e-2


# -- eviction / bookkeeping ----------------------------------------------


def test_eviction_boundaries():
    model, ts, y = _linear_data(40)
    lag = 10
    eng = _engine(model, lag=lag, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=10)
    track = eng._tracks[tid]
    assert track.y.shape[0] == lag
    assert track.offset == 40 - lag
    committed = eng.committed(tid)
    assert tuple(committed.x.shape) == (40 - lag, model.nx)
    window = eng.window(tid)
    assert tuple(window.x.shape) == (lag + 1, model.nx)
    full = eng.estimate(tid)
    assert tuple(full.x.shape) == (41, model.nx)
    assert torch.equal(full.x[:40 - lag], committed.x)
    assert torch.equal(full.x[40 - lag:], window.x)
    final = eng.close(tid)
    assert torch.equal(final.x, full.x)
    assert eng.tracks() == []
    with pytest.raises(KeyError, match="unknown track"):
        eng.estimate(tid)


def test_no_eviction_before_lag():
    model, ts, y = _linear_data(10)
    eng = _engine(model, lag=20, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=5)
    assert eng.committed(tid) is None
    assert tuple(eng.estimate(tid).x.shape) == (11, model.nx)


def test_multi_track_waves_batch_together():
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tids = [eng.open_track(ts[0]) for _ in range(4)]
    datasets = []
    for i, tid in enumerate(tids):
        datasets.append(_linear_data(20, seed=100 + i)[2])
        eng.push(tid, ts[1:], datasets[-1])
    assert eng.due() == 4
    assert eng.run() == 4
    assert eng.waves == 2
    for tid, yi in zip(tids, datasets):
        solo = _engine(model, lag=8, batch=2, options=OPTIONS)
        stid = solo.open_track(ts[0])
        solo.push(stid, ts[1:], yi)
        solo.run()
        np.testing.assert_allclose(eng.estimate(tid).x.numpy(),
                                   solo.estimate(stid).x.numpy(), rtol=0,
                                   atol=1e-10)


def test_threaded_push_and_solve():
    model, ts, y = _linear_data(30)
    lag = 30
    eng = _engine(model, lag=lag, batch=2, options=OPTIONS)
    n_tracks = 4
    tids = [eng.open_track(ts[0]) for _ in range(n_tracks)]
    datasets = [_linear_data(30, seed=7 + i)[2] for i in range(n_tracks)]
    stop = threading.Event()

    def solver():
        while not stop.is_set() or eng.due():
            if not eng.step():
                stop.wait(0.001)

    def client(tid, yi):
        for i in range(0, 30, 6):
            eng.push(tid, ts[i + 1:i + 7], yi[i:i + 6])

    solver_t = threading.Thread(target=solver)
    solver_t.start()
    clients = [threading.Thread(target=client, args=(tid, yi))
               for tid, yi in zip(tids, datasets)]
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    stop.set()
    solver_t.join()
    assert eng.due() == 0
    for tid, yi in zip(tids, datasets):
        ref = _offline(model, ts, yi)
        np.testing.assert_allclose(eng.estimate(tid).x.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.max(np.abs(ref)))


def test_threaded_stress_counts_every_push():
    """More client threads than cores push one interval at a time, with a
    short switch interval, while a solver thread drains: no push is lost
    (every track ends with all its intervals, and the obs counters add up
    exactly)."""
    import os
    import sys

    model, ts, y = _linear_data(12)
    n_clients = 2 * (os.cpu_count() or 4)
    eng = _engine(model, lag=4, batch=3, options=OPTIONS)
    tids = [eng.open_track(ts[0]) for _ in range(n_clients)]
    obs.enable()
    stop = threading.Event()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def solver():
            while not stop.is_set() or eng.due():
                if not eng.step():
                    stop.wait(0.0005)

        def client(tid):
            for i in range(12):
                eng.push(tid, ts[i + 1:i + 2], y[i:i + 1])

        threads = [threading.Thread(target=client, args=(t,)) for t in tids]
        solver_t = threading.Thread(target=solver)
        solver_t.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
        stop.set()
        solver_t.join(60.0)
        assert not solver_t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    c = obs.snapshot()["counters"]
    assert c["stream.pushes"] == c["stream.pushed_intervals"] == 12 * n_clients
    for tid in tids:
        assert tuple(eng.estimate(tid).x.shape) == (13, model.nx)
    assert eng.evicted_intervals == c["stream.evicted_intervals"]
    assert not eng._inflight


def test_estimate_refresh_waits_for_in_flight_solve():
    """``estimate(refresh=True)`` waits for an in-flight wave of its track
    to land, then solves anything newer."""
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=30, batch=1, options=OPTIONS)
    tid = eng.open_track(ts[0])
    eng.push(tid, ts[1:6], y[:5])
    eng.run()
    entered, release = threading.Event(), threading.Event()
    real_solve = eng.estimator.solve

    def slow_solve(problem):
        entered.set()
        assert release.wait(60.0)
        return real_solve(problem)

    eng.estimator.solve = slow_solve
    got = {}
    try:
        eng.push(tid, ts[6:11], y[5:10])
        solver = threading.Thread(target=eng.step)
        solver.start()
        assert entered.wait(60.0)
        eng.push(tid, ts[11:21], y[10:20])
        reader = threading.Thread(
            target=lambda: got.update(x=eng.estimate(tid).x.numpy()))
        reader.start()
        reader.join(0.5)
        assert reader.is_alive(), \
            "estimate(refresh=True) returned while a solve was in flight"
        release.set()
        solver.join(60.0)
        reader.join(60.0)
        assert not reader.is_alive()
    finally:
        eng.estimator.solve = real_solve
        release.set()
    assert got["x"].shape == (21, model.nx)
    ref = _offline(model, ts, y)
    np.testing.assert_allclose(got["x"], ref, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref)))
    assert not eng._inflight


def test_push_during_solve_marks_due_again():
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    eng.push(tid, ts[1:11], y[:10])
    eng.run()
    assert eng.due() == 0
    eng.push(tid, ts[11:21], y[10:20])
    assert eng.due() == 1


# -- validation ----------------------------------------------------------


def test_push_validation():
    model, ts, y = _linear_data(10)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    with pytest.raises(ValueError, match="strictly increasing"):
        eng.push(tid, [0.2, 0.1], y[:2])
    assert eng.push(tid, [0.0], y[:1])["dropped_late"] == 1
    assert eng.due() == 0
    with pytest.raises(ValueError, match="measurement dimension"):
        eng.push(tid, ts[1:2], np.zeros((1, 3)))
    with pytest.raises(ValueError, match=r"\(K, ny\)"):
        eng.push(tid, ts[1:3], y[:1])
    with pytest.raises(KeyError, match="unknown track"):
        eng.push(99, ts[1:2], y[:1])
    eng.push(tid, ts[1:3], y[:2])
    with pytest.raises(ValueError, match="duplicate"):
        eng.push(tid, ts[2:4], y[1:3])


def test_estimate_before_solve_raises():
    model, ts, y = _linear_data(10)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    with pytest.raises(ValueError, match="no estimate yet"):
        eng.estimate(tid)
    eng.push(tid, ts[1:], y)
    with pytest.raises(ValueError, match="no estimate yet"):
        eng.window(tid)
    eng.run()
    assert tuple(eng.estimate(tid).x.shape) == (11, model.nx)


def test_constructor_validation():
    model = _WIENER
    for kw, match in (
            (dict(lag=0), "lag"), (dict(batch=0), "batch"),
            (dict(duplicate_policy="overwrite"), "duplicate_policy"),
            (dict(reorder_slack=-1), "reorder_slack"),
            (dict(max_committed_states=-1), "max_committed_states"),
            (dict(lag_min=2), "committed_error_target"),
            (dict(committed_error_target=0.0), "committed_error_target"),
            (dict(committed_error_target=0.1, lag_min=8, lag_max=4),
             "lag_max")):
        with pytest.raises(ValueError, match=match):
            _engine(model, **kw)
    eng = _engine(model, lag=32, committed_error_target=0.1, lag_min=2,
                  lag_max=8)
    assert eng.lag == 8


def test_device_and_mesh_rules():
    if torch.cuda.is_available():
        assert StreamingEngine(_WIENER).estimator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingEngine(_WIENER)
    with pytest.raises(NotImplementedError, match="mesh"):
        _engine(_WIENER, mesh=object())


# -- satellite regressions -------------------------------------------------


def test_estimate_solves_due_tracks_on_demand():
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=30, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    eng.push(tid, ts[1:11], y[:10])
    eng.run()
    eng.push(tid, ts[11:21], y[10:20])
    stale = eng.estimate(tid, refresh=False)
    assert tuple(stale.x.shape) == (11, model.nx)
    fresh = eng.estimate(tid)
    assert tuple(fresh.x.shape) == (21, model.nx)
    assert eng.due() == 0
    ref = _offline(model, ts, y)
    np.testing.assert_allclose(fresh.x.numpy(), ref, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref)))


def test_max_committed_states_bounds_history():
    model, ts, y = _linear_data(40)
    obs.enable()
    cap = 8
    eng = _engine(model, lag=5, batch=2, options=OPTIONS,
                  max_committed_states=cap)
    ref = _engine(model, lag=5, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=7)
    rid = ref.open_track(ts[0])
    _stream(ref, rid, ts, y, chunk=7)
    committed = eng.committed(tid)
    assert committed.x.shape[0] == cap
    full = ref.committed(rid)
    assert torch.equal(committed.x, full.x[-cap:])
    assert torch.equal(committed.S, full.S[-cap:])
    evicted = full.x.shape[0]
    assert obs.snapshot()["counters"]["stream.committed_trimmed"] == \
        evicted - cap
    assert eng._tracks[tid].offset == evicted
    assert eng.estimate(tid).x.shape[0] == cap + eng.window(tid).x.shape[0]
    final = eng.close(tid)
    assert final.x.shape[0] == cap + (40 - evicted) + 1


def test_due_since_is_push_relative_not_epoch():
    model, ts, y = _linear_data(10)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS,
                  duplicate_policy="replace")
    tid = eng.open_track(ts[0])
    assert time.perf_counter() - eng._tracks[tid].due_since < 5.0
    obs.enable()
    eng.push(tid, ts[1:6], y[:5])
    eng.run()
    eng.push(tid, ts[3:4], y[2:3] + 1.0)
    assert eng.due() == 1
    eng.run()
    lat = obs.histogram("stream.window_latency_seconds").summary()
    assert lat["count"] == 2
    assert lat["max"] < 60.0


def test_default_options_are_numerically_robust():
    model, ts, y = _linear_data(45, T=4.5)   # dt = 0.1, bucket 80
    eng = _engine(model, lag=50, batch=2)    # options=None
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=45)
    assert torch.isfinite(eng.estimate(tid).x).all()


def test_readers_return_copies_on_the_cpu():
    """The readers build CPU tensors from the host state; changing one
    does not change the engine's state."""
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    tid = eng.open_track(ts[0])
    _stream(eng, tid, ts, y, chunk=10)
    win = eng.window(tid)
    assert win.x.device.type == "cpu" and win.x.dtype == torch.float64
    before = win.x.clone()
    win.x.zero_()
    assert torch.equal(eng.window(tid).x, before)
    assert isinstance(eng._tracks[tid].win_x, np.ndarray)


# -- observability -------------------------------------------------------


def test_stream_obs_taxonomy():
    obs.enable()
    model, ts, y = _linear_data(20)
    eng = _engine(model, lag=8, batch=2, options=OPTIONS)
    t0, t1 = eng.open_track(ts[0]), eng.open_track(ts[0])
    for tid in (t0, t1):
        eng.push(tid, ts[1:11], y[:10])
        eng.push(tid, ts[11:21], y[10:20])
    eng.run()
    eng.close(t1)
    snap = obs.snapshot()
    counters = snap["counters"]
    assert counters["stream.tracks_opened"] == 2
    assert counters["stream.pushes"] == 4
    assert counters["stream.pushed_intervals"] == 40
    assert counters["stream.waves"] >= 1
    assert counters["stream.completed"] == 2
    assert counters["stream.evicted_intervals"] == 2 * (20 - 8)
    assert snap["gauges"]["stream.tracks"] == 1
    assert "stream.padding_waste" in snap["gauges"]
    assert snap["gauges"]["stream.lag"] == eng.lag
    hists = snap["histograms"]
    assert hists["stream.window_latency_seconds"]["count"] == 2
    assert "stream.wave_occupancy" in hists
