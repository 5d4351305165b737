"""The PyTorch port's ``TrajectoryEngine``, held against the JAX
reference's, and the reference's ``tests/test_trajectory_engine.py`` cases
on the port (all but the sharded batch path: the port has no sharding).

Both engines get the same numpy records, simulated by the reference.  The
port's ``parallel_kernel`` runs on the CPU through its kernel's plain
version.  Tolerances: solutions equal to the reference engine's at
1e-9 x scale (the same arithmetic on the same padded waves), the wave and
recycled-row counts and the ``engine.*`` counters exactly; the
reference's own tests' bounds elsewhere.
"""
import gc
import threading

import jax
import numpy as np
import pytest
import torch

from helpers import wiener_velocity
from repro import obs as jobs
from repro.core import clear_cache as jclear_cache
from repro.core import ParallelOptions as JParallelOptions
from repro.core import simulate_linear as jsimulate_linear
from repro.core import time_grid
from repro.serving import TrajectoryEngine as JTrajectoryEngine
from repro_torch import obs
from repro_torch.convert import linear_sde_from_numpy
from repro_torch.core import (
    Estimator,
    KernelOptions,
    ParallelOptions,
    Problem,
    SequentialOptions,
)
from repro_torch.serving import TrajectoryEngine
from repro_torch.serving.waves import robust_default_options

torch.set_num_threads(1)

NSUB = 5
OPTIONS = ParallelOptions(nsub=NSUB, mode="discrete")
LENGTHS = (12, 20, 35, 20, 17, 7, 40)     # buckets 10, 20 and 40 at nsub 5
ENGINE_COUNTERS = ("submitted", "completed", "waves", "recycled_rows",
                   "real_intervals", "padded_intervals")


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


_RECORDS = {}


def _record(N, seed, T=None):
    """A Wiener-velocity record simulated by the reference (cached)."""
    key = (N, seed, T)
    if key not in _RECORDS:
        ts = time_grid(0.0, N / 20.0 if T is None else T, N)
        _, y = jsimulate_linear(wiener_velocity(), ts,
                                jax.random.PRNGKey(seed))
        _RECORDS[key] = (np.asarray(ts), np.asarray(y))
    return _RECORDS[key]


@pytest.fixture(scope="module")
def model():
    return _port_linear(wiener_velocity())


def _engine(model, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("options", OPTIONS)
    kw.setdefault("device", "cpu")
    return TrajectoryEngine(model, **kw)


# -- parity with the reference engine -----------------------------------------


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine over LENGTHS once, with its obs enabled."""
    recs = [_record(N, 10 + i) for i, N in enumerate(LENGTHS)]
    was = jobs.enabled()
    jobs.reset()
    jobs.enable()
    try:
        eng = JTrajectoryEngine(wiener_velocity(), batch=4,
                                options=JParallelOptions(nsub=NSUB,
                                                         mode="discrete"))
        sols = eng.estimate(recs)
        counters = dict(jobs.snapshot()["counters"])
    finally:
        jobs.reset()
        (jobs.enable if was else jobs.disable)()
    return dict(records=recs, engine=eng, counters=counters,
                x=[np.asarray(s.x) for s in sols],
                S=[np.asarray(s.S) for s in sols],
                cost=[float(s.cost) for s in sols])


@pytest.mark.parametrize("method,options", [
    ("parallel_rts", OPTIONS),
    ("parallel_kernel", KernelOptions(nsub=NSUB, mode="discrete"))])
def test_engine_matches_reference_engine(model, reference_run, method,
                                         options):
    ref = reference_run
    obs.enable()
    eng = _engine(model, method=method, options=options)
    sols = eng.estimate(ref["records"])
    counters = obs.snapshot()["counters"]
    assert (eng.waves, eng.recycled_rows) == (ref["engine"].waves,
                                               ref["engine"].recycled_rows)
    for name in ENGINE_COUNTERS:
        assert counters[f"engine.{name}"] == ref["counters"][
            f"engine.{name}"], name
    for sol, x, S, cost, (_, y) in zip(sols, ref["x"], ref["S"],
                                       ref["cost"], ref["records"]):
        assert tuple(sol.x.shape) == (y.shape[0] + 1, 4)
        scale = np.max(np.abs(x))
        np.testing.assert_allclose(sol.x.numpy(), x, rtol=0,
                                   atol=1e-9 * scale)
        np.testing.assert_allclose(sol.S.numpy(), S, rtol=0,
                                   atol=1e-9 * np.max(np.abs(S)))
        assert float(sol.cost) == pytest.approx(cost, rel=1e-9)


def test_robust_default_options_match_reference():
    from repro.serving.waves import robust_default_options as jdefault

    for method in ("parallel_rts", "parallel_kernel", "sequential_rts",
                   "sigma_point"):
        got, want = robust_default_options(method), jdefault(method)
        assert type(got).__name__ == type(want).__name__
        inner = getattr(got, "inner", got)
        assert inner.mode == getattr(want, "inner", want).mode == "discrete"
    assert robust_default_options("sigma_point").inner_method == \
        "parallel_rts"


# -- the reference's cases, on the port --------------------------------------


def test_submit_step_collect_cycle(model):
    engine = _engine(model)
    recs = [_record(20, s) for s in range(6)]         # one bucket, 2 waves
    tickets = [engine.submit(ts, y) for ts, y in recs]
    assert tickets == list(range(6))
    assert engine.pending() == 6
    assert engine.collect() == []

    assert engine.step() == 4
    assert engine.pending() == 2
    got = engine.collect()
    assert [t for t, _ in got] == tickets[:4]
    assert engine.collect() == []

    assert engine.run() == 2
    assert [t for t, _ in engine.collect()] == tickets[4:]
    assert engine.step() == 0
    assert engine.waves == 2
    assert engine.recycled_rows == 2


def test_results_match_direct_solve(model):
    engine = _engine(model, method="parallel_rts")
    recs = [_record(N, 10 + i) for i, N in enumerate([12, 20, 35, 20, 17])]
    sols = engine.estimate(recs)
    seq = Estimator(model, method="sequential_rts",
                    options=SequentialOptions(mode="discrete"), device="cpu")
    for (ts, y), sol in zip(recs, sols):
        assert tuple(sol.x.shape) == (y.shape[0] + 1, model.nx)
        ref = seq.solve(Problem.single(model, ts, y))
        np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), atol=1e-6,
                                   rtol=0)


def test_waves_group_by_bucket_fifo(model):
    engine = _engine(model, batch=2)
    t0 = engine.submit(*_record(12, 20))      # bucket 20
    t1 = engine.submit(*_record(35, 21))      # bucket 40
    t2 = engine.submit(*_record(18, 22))      # bucket 20
    assert engine.step() == 2
    assert sorted(t for t, _ in engine.collect()) == sorted([t0, t2])
    assert engine.step() == 1
    assert [t for t, _ in engine.collect()] == [t1]


def test_estimate_preserves_submission_order(model):
    engine = _engine(model, batch=2)
    recs = [_record(N, 30 + i) for i, N in enumerate([35, 12, 35, 12])]
    sols = engine.estimate(recs)
    for (ts, y), sol in zip(recs, sols):
        assert sol.x.shape[0] == y.shape[0] + 1


def test_submit_validation_and_config_errors(model):
    engine = _engine(model)
    ts, y = _record(20, 40)
    with pytest.raises(ValueError):
        engine.submit(ts[:-1], y)
    with pytest.raises(ValueError):
        engine.submit(ts, y[:, 0])
    with pytest.raises(ValueError):
        TrajectoryEngine(model, batch=0, device="cpu")
    with pytest.raises(TypeError):
        TrajectoryEngine(model, n_sub=3, device="cpu")
    with pytest.raises(TypeError):
        TrajectoryEngine(model, options=OPTIONS, nsub=3, device="cpu")


def test_legacy_kwargs_warn_and_map_to_options(model):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        engine = TrajectoryEngine(model, nsub=NSUB, mode="discrete",
                                  device="cpu")
    assert engine.estimator.options == ParallelOptions(nsub=NSUB,
                                                       mode="discrete")


def test_device_and_mesh_rules(model):
    """``device=None`` means the card and raises without one; a mesh is
    refused (the port has no sharding)."""
    if torch.cuda.is_available():
        assert TrajectoryEngine(model).estimator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrajectoryEngine(model)
    with pytest.raises(NotImplementedError, match="mesh"):
        TrajectoryEngine(model, device="cpu", mesh=object())


def test_sequential_engine_uses_unit_buckets(model):
    engine = TrajectoryEngine(model, batch=2, method="sequential_rts",
                              device="cpu")
    assert engine.estimator.block_size == 1
    engine.submit(*_record(12, 60))
    assert engine._queue[0].n_pad == 16


def test_submit_rejects_non_monotone_ts(model):
    engine = _engine(model)
    ts, y = _record(12, 70)
    bad = ts.copy()
    bad[5], bad[6] = bad[6], bad[5]
    with pytest.raises(ValueError, match="strictly increasing"):
        engine.submit(bad, y)
    with pytest.raises(ValueError, match="strictly increasing"):
        engine.submit(np.concatenate([ts[:-1], ts[-2:-1]]), y)
    assert engine.pending() == 0


def test_collect_ticket_filter_prevents_races(model):
    engine = _engine(model, batch=2)
    t_a = engine.submit(*_record(12, 80))
    t_b = engine.submit(*_record(12, 81))
    engine.run()
    got_b = engine.collect(tickets=[t_b])
    assert [t for t, _ in got_b] == [t_b]
    got_a = engine.collect(tickets=[t_a, 999])
    assert [t for t, _ in got_a] == [t_a]
    assert engine.collect() == []


def test_estimate_explains_unredeemable_tickets(model):
    engine = _engine(model, batch=2)
    ticket = engine.submit(*_record(12, 90))
    engine.run()
    thief = engine.collect()
    assert [t for t, _ in thief] == [ticket]
    assert "already collected" in engine.describe_ticket(ticket)
    assert "never issued" in engine.describe_ticket(12345)
    queued = engine.submit(*_record(12, 91))
    assert "queued" in engine.describe_ticket(queued)
    engine.run()
    assert "finished" in engine.describe_ticket(queued)


def test_default_options_are_numerically_robust(model):
    engine = TrajectoryEngine(model, batch=2, device="cpu")   # options=None
    [sol] = engine.estimate([_record(80, 99, T=8.0)])          # dt = 0.1
    assert torch.isfinite(sol.x).all()


# -- the engine.* taxonomy (the reference's tests/test_obs.py cases) ----------


def _engine_records(lengths, rng):
    out = []
    for n in lengths:
        ts = np.linspace(0.0, n / 32.0, n + 1)
        out.append((ts, rng.standard_normal((n, 2))))
    return out


def test_engine_wave_and_latency_metrics(model):
    obs.enable()
    engine = _engine(model, method="parallel_rts",
                     options=ParallelOptions(nsub=NSUB))
    recs = _engine_records([7, 12, 9, 14, 8, 11], np.random.default_rng(0))
    sols = engine.estimate(recs)
    assert len(sols) == 6
    snap = obs.snapshot()
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    assert c["engine.submitted"] == 6
    assert c["engine.completed"] == 6
    assert c["engine.waves"] == engine.waves
    assert c["engine.real_intervals"] == 7 + 12 + 9 + 14 + 8 + 11
    assert c["engine.padded_intervals"] >= c["engine.real_intervals"]
    assert 0.0 <= g["engine.padding_waste"] < 1.0
    assert g["engine.queue_depth"] == 0
    assert g["engine.tracks_per_sec"] > 0
    assert h["engine.record_latency_seconds"]["count"] == 6
    assert h["engine.record_latency_seconds"]["p50"] > 0
    assert h["engine.wave_occupancy"]["count"] == engine.waves
    assert h["span.engine.step"]["count"] == engine.waves


def test_engine_threaded_submits_counted_exactly(model):
    obs.enable()
    engine = _engine(model, method="parallel_rts",
                     options=ParallelOptions(nsub=NSUB))
    per_thread = 5

    def submit_some(seed):
        for ts, y in _engine_records([10] * per_thread,
                                     np.random.default_rng(seed)):
            engine.submit(ts, y)

    threads = [threading.Thread(target=submit_some, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert engine.run() == 4 * per_thread
    snap = obs.snapshot()
    assert snap["counters"]["engine.submitted"] == 4 * per_thread
    assert snap["counters"]["engine.completed"] == 4 * per_thread
    assert (snap["histograms"]["engine.record_latency_seconds"]["count"]
            == 4 * per_thread)


def test_pack_wave_is_one_copy_per_array_on_the_host(model):
    """``pack_wave`` pads and stacks on the host: every returned tensor is
    one contiguous stacked array on the requested device and dtype, short
    waves recycle row 0, and the padding equals ``pad_record``'s."""
    from repro_torch.core.padding import pad_record
    from repro_torch.serving.waves import WaveItem, pack_wave

    recs = [_record(12, 1), _record(17, 2)]
    wave = [WaveItem(i, ts, y, 20, prior=(np.eye(4) * (i + 1), np.ones(4)),
                     x_init=np.zeros((y.shape[0] + 1, 4)))
            for i, (ts, y) in enumerate(recs)]
    ts_b, ys_b, mask_b, xi_b, (S_b, v_b) = pack_wave(
        wave, 4, device="cpu", dtype=torch.float64)
    assert tuple(ts_b.shape) == (4, 21) and tuple(ys_b.shape) == (4, 20, 2)
    assert tuple(xi_b.shape) == (4, 21, 4) and tuple(S_b.shape) == (4, 4, 4)
    for t in (ts_b, ys_b, mask_b, xi_b, S_b, v_b):
        assert t.is_contiguous() and t.dtype == torch.float64
    for row, src in enumerate([0, 1, 0, 0]):
        ts, y = recs[src]
        want = pad_record(torch.tensor(ts), torch.tensor(y), 20)
        for got, w in zip((ts_b[row], ys_b[row], mask_b[row]), want):
            assert torch.equal(got, w)
        assert float(S_b[row, 0, 0]) == src + 1
