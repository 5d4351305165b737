"""The PyTorch port's telemetry (``repro_torch.obs``): the registry's
semantics (the reference's ``tests/test_obs.py`` cases), the estimator's
instrumentation, and parity of the recorded metrics with the JAX
reference on the same solves.

One documented difference from the reference: on a fresh executable the
reference's ``linearize.slr.*`` counters count once per traced call site,
the port's count every regression its entry's first run performs (on a
cache hit both count nothing).  One addition: the port's linear solves
count how the OM cost factored Q (``cost.qpinv.once`` for a constant Q,
``cost.qpinv.grid`` for a callable one), which the reference does not
count.  Everything else -- names and values of
the ``cache.*``, ``estimator.*``, ``nonlinear.*``, ``linearize.*`` and
``padding.*`` metrics, the fresh entry's ``compile`` span included -- must
agree (counts exactly, costs to 1e-9).
"""
import gc
import json
import threading

import jax
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro import obs as jobs
from repro.core import clear_cache as jclear_cache
from repro.core import Estimator as JEstimator
from repro.core import ExecutableCache
from repro.core import IteratedOptions as JIteratedOptions
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import SigmaPointOptions as JSigmaPointOptions
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro_torch import obs
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.core import ExecutableCache as TExecutableCache
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    Problem,
    SequentialOptions,
    SigmaPointOptions,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB = 5
ITERS = 5


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts disabled + empty (both packages) and leaves no
    obs state behind."""
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


def _same(a, b) -> bool:
    return (a is None and b is None) or torch.equal(a, b)


def _port_linear(jmodel):
    return linear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k))
         for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")})


def _port_ct(jmodel):
    ref = CoordinatedTurnConfig().model()
    return nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)


@pytest.fixture(scope="module")
def lin():
    jmodel = wiener_velocity()
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    _, y = jsimulate_linear(jmodel, ts, jax.random.PRNGKey(0))
    return jmodel, _port_linear(jmodel), np.asarray(ts), np.asarray(y)


@pytest.fixture(scope="module")
def ct():
    jmodel = coordinated_turn()
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    _, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(0))
    return jmodel, _port_ct(jmodel), np.asarray(ts), np.asarray(y)


# -- registry semantics -----------------------------------------------------


def test_counter_gauge_histogram_basics():
    obs.enable()
    obs.inc("a.count")
    obs.inc("a.count", 4)
    obs.set_gauge("a.depth", 3)
    obs.set_gauge("a.depth", 7.5)          # last write wins
    for v in (0.001, 0.01, 0.01, 0.1):
        obs.record("a.lat", v)
    snap = obs.snapshot()
    assert snap["enabled"] is True
    assert snap["counters"]["a.count"] == 5
    assert snap["gauges"]["a.depth"] == 7.5
    h = snap["histograms"]["a.lat"]
    assert h["count"] == 4
    assert h["min"] == pytest.approx(0.001)
    assert h["max"] == pytest.approx(0.1)
    assert h["sum"] == pytest.approx(0.121)
    assert snap["dropped_records"] == 0


def test_histogram_matches_reference_buckets_and_percentiles():
    """Same geometric buckets and percentile rule as the reference: the
    same values give the same summary, to the bit."""
    vals = np.random.default_rng(0).lognormal(-5.0, 2.0, 500)
    for o in (obs, jobs):
        o.enable()
        for v in vals:
            o.record("h", float(v))
    got = obs.snapshot()["histograms"]["h"]
    assert got == jobs.snapshot()["histograms"]["h"]
    assert obs.histogram("h").edges == jobs.histogram("h").edges
    h = obs.histogram("h")
    for q in (0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == jobs.histogram("h").percentile(q)


def test_histogram_percentiles_bucket_accurate():
    obs.enable()
    vals = [i / 1000.0 for i in range(1, 1001)]      # 1ms .. 1s uniform
    for v in vals:
        obs.record("h", v)
    h = obs.histogram("h")
    for q, true in ((0.5, 0.5), (0.9, 0.9), (0.99, 0.99)):
        est = h.percentile(q)
        assert vals[0] <= est <= vals[-1]
        assert true / 2.2 <= est <= true * 2.2, (q, est)
    assert h.percentile(1.0) == pytest.approx(1.0)


def test_exact_counts_under_threads():
    obs.enable()
    threads = [
        threading.Thread(target=lambda: [
            (obs.inc("t.count"), obs.record("t.hist", 0.01))
            for _ in range(1000)])
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert obs.counter("t.count").value == 8000
    assert obs.histogram("t.hist").count == 8000


def test_disabled_is_a_noop_that_allocates_nothing():
    assert not obs.enabled()
    obs.inc("x")
    obs.set_gauge("y", 1.0)
    obs.record("z", 0.5)
    with obs.trace_span("w", record_function=True):
        pass
    assert obs.REGISTRY.is_empty()
    assert obs.span_trees() == []
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}


def test_scalar_tensors_recorded_others_dropped():
    """0-d tensors are read with ``.item()``; values that refuse
    ``float`` -- a tensor of three elements, a batched tensor under
    ``torch.func.vmap`` -- are dropped and counted, never captured, and
    the code around them runs on."""
    obs.enable()
    obs.record("scalar", torch.tensor(2.5, dtype=torch.float64))
    obs.set_gauge("gauge0d", torch.tensor(3))
    obs.record("vector", torch.ones(3))

    def f(x):
        obs.record("vmapped.value", x)
        obs.set_gauge("vmapped.gauge", x)
        return x * 2.0

    out = torch.func.vmap(f)(torch.arange(4.0))
    assert torch.equal(out, torch.arange(4.0) * 2.0)
    snap = obs.snapshot()
    assert snap["histograms"]["scalar"]["sum"] == 2.5
    assert snap["gauges"]["gauge0d"] == 3.0
    for name in ("vector", "vmapped.value"):
        assert name not in snap["histograms"]
    assert "vmapped.gauge" not in snap["gauges"]
    assert snap["dropped_records"] == 3


def test_span_trees_nest_and_time():
    obs.enable()
    with obs.trace_span("outer"):
        with obs.trace_span("inner"):
            pass
        with obs.trace_span("inner", record_function=True):
            pass
    trees = obs.span_trees()
    assert len(trees) == 1
    root = trees[0]
    assert root["name"] == "outer"
    assert [c["name"] for c in root["children"]] == ["inner", "inner"]
    assert root["dur_s"] >= max(c["dur_s"] for c in root["children"]) >= 0
    snap = obs.snapshot()
    assert snap["histograms"]["span.outer"]["count"] == 1
    assert snap["histograms"]["span.inner"]["count"] == 2
    obs.reset()
    assert obs.span_trees() == [] and obs.REGISTRY.is_empty()
    assert obs.enabled()                       # reset keeps the flag


def test_torch_profile_writes_trace_with_labelled_spans(tmp_path):
    """``torch_profile`` (the reference's ``xla_profile``) writes a Chrome
    trace; a span entered with ``record_function=True`` is a labelled
    range in it."""
    obs.enable()
    with obs.torch_profile(str(tmp_path)) as prof:
        with obs.trace_span("port.labelled", record_function=True):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "port.labelled" in names
    assert any(e.key == "port.labelled" for e in prof.key_averages())


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_trace_range_labels_a_profile_and_records_nothing(telemetry):
    """``tracing.trace_range`` is a range on a recording profiler's
    timeline alone: no span tree, no histogram, no counter, whether
    telemetry is on or off."""
    from repro_torch.obs.tracing import trace_range

    if telemetry:
        obs.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_range("port.range"):
            torch.ones(8).sum()
    assert [e.name for e in prof.events()].count("port.range") == 1
    assert obs.REGISTRY.is_empty()
    assert obs.span_trees() == []


def test_trace_range_without_a_profiler_opens_nothing(monkeypatch):
    """Without a recording profiler ``trace_range`` never reaches
    ``record_function``: it hands back one shared no-op context."""
    from repro_torch.obs import tracing

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was called")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for telemetry in (False, True):
        (obs.enable if telemetry else obs.disable)()
        a, b = tracing.trace_range("x"), tracing.trace_range("y")
        assert a is b
        with a:
            pass
        with obs.trace_span("w"):
            pass
    assert "trace_range" not in obs.__all__


def test_trace_span_labels_a_profile_with_telemetry_off():
    """``trace_span`` puts its name on a recording profiler's timeline
    with telemetry off too (its ``record_function`` argument changes
    nothing), and records no span there."""
    assert not obs.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.trace_span("port.span"):
            torch.ones(8).sum()
        with obs.trace_span("port.span", record_function=False):
            pass
    assert [e.name for e in prof.events()].count("port.span") == 2
    assert obs.span_trees() == [] and obs.REGISTRY.is_empty()


def test_public_surface_matches_reference():
    """The reference's ``__all__`` with its two profiler names in
    PyTorch's wording."""
    renamed = {"xla_profile": "torch_profile"}
    assert sorted(obs.__all__) == sorted(renamed.get(n, n)
                                         for n in jobs.__all__)


# -- export -------------------------------------------------------------------


def test_bench_record_validates_and_round_trips(tmp_path):
    obs.enable()
    obs.inc("estimator.solves", 2)
    rec = obs.bench_record("port_smoke",
                           [{"name": "solve", "us_per_call": 12.5,
                             "derived": "x"}], seeds={"data": 0})
    assert obs.validate_bench(rec) == []
    assert jobs.validate_bench(rec) == []         # the reference's schema
    assert rec["schema_version"] == jobs.SCHEMA_VERSION == obs.SCHEMA_VERSION
    assert obs.ROW_KEYS == jobs.ROW_KEYS
    env = rec["env"]
    for key in ("torch", "torch_cuda", "device_kind", "device_count",
                "power_limit", "default_dtype", "cuda_visible_devices"):
        assert key in env
    assert not any("jax" in k or "xla" in k for k in env)
    assert env["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert env["device_count"] == 0 and env["power_limit"] is None
    path = obs.write_bench_json(str(tmp_path / "BENCH_port.json"), rec)
    back = json.loads(open(path).read())
    assert back["obs"]["counters"]["estimator.solves"] == 2
    bad = dict(rec, rows=[{"name": "x"}])
    assert obs.validate_bench(bad)
    with pytest.raises(ValueError, match="invalid benchmark record"):
        obs.write_bench_json(str(tmp_path / "bad.json"), bad)


# -- estimator instrumentation ----------------------------------------------


def test_solve_bit_identical_with_obs_on_and_off(lin, ct):
    _, tmodel, ts, y = lin
    for method, opts in (("parallel_rts", ParallelOptions(nsub=NSUB)),
                         ("parallel_kernel", KernelOptions(nsub=NSUB))):
        est = Estimator(tmodel, method=method, options=opts, device="cpu")
        problem = Problem.single(tmodel, ts, y)
        obs.disable()
        off = est.solve(problem)
        obs.enable()
        on = est.solve(problem)
        for f in ("x", "S", "v", "cov", "cost"):
            assert _same(getattr(off, f), getattr(on, f)), f
    _, cmodel, cts, cy = ct
    est = Estimator(cmodel, method="sigma_point", device="cpu",
                    options=SigmaPointOptions(
                        inner=ParallelOptions(nsub=NSUB, mode="discrete"),
                        iterations=2))
    problem = Problem.single(cmodel, cts, cy)
    obs.disable()
    off = est.solve(problem)
    obs.enable()
    on = est.solve(problem)
    for f in ("x", "S", "v", "cost_trace", "step_norms"):
        assert _same(getattr(off, f), getattr(on, f)), f
    assert obs.snapshot()["dropped_records"] == 0


def test_solve_phases_and_counters(lin):
    obs.enable()
    _, tmodel, ts, y = lin
    est = Estimator(tmodel, method="parallel_rts",
                    options=ParallelOptions(nsub=NSUB), device="cpu",
                    cache=TExecutableCache())
    est.solve(Problem.single(tmodel, ts, y))      # a new entry
    est.solve(Problem.single(tmodel, ts, y))      # cached
    snap = obs.snapshot()
    assert snap["counters"] == {"estimator.solves": 2, "cache.misses": 1,
                                "cache.hits": 1, "cost.qpinv.once": 2}
    h = snap["histograms"]
    for phase in ("", ".prepare", ".host_transfer"):
        assert h[f"span.estimator.solve{phase}"]["count"] == 2
    assert h["span.estimator.solve.compile"]["count"] == 1
    assert h["span.estimator.solve.execute"]["count"] == 1
    assert h["cache.compile_seconds"]["count"] == 1
    assert h["estimator.final_cost"]["count"] == 2
    first, second = obs.span_trees()[-2:]
    for root, phase in ((first, "compile"), (second, "execute")):
        assert [c["name"] for c in root["children"]] == [
            "estimator.solve.prepare", f"estimator.solve.{phase}",
            "estimator.solve.host_transfer"]


def test_nonlinear_iteration_metrics_and_step_norms(ct):
    obs.enable()
    _, cmodel, ts, y = ct
    est = Estimator(cmodel, method="parallel_rts", device="cpu",
                    options=IteratedOptions(
                        inner=ParallelOptions(nsub=NSUB), iterations=ITERS))
    sol = est.solve(Problem.single(cmodel, ts, y))
    steps = sol.step_norms.numpy()
    assert steps.shape == (ITERS,)
    assert steps[-1] < steps[0]
    snap = obs.snapshot()
    assert snap["gauges"]["nonlinear.iterations"] == ITERS
    assert snap["gauges"]["linearize.sigma_points"] == 1
    assert snap["counters"]["linearize.taylor.solves"] == 1
    assert snap["histograms"]["nonlinear.final_step_norm"]["count"] == 1
    assert snap["histograms"]["nonlinear.cost_decrease"]["count"] == 1


def test_diagnostics_false_keeps_hot_path_silent(lin):
    obs.enable()
    _, tmodel, ts, y = lin
    est = Estimator(tmodel, method="sequential_rts",
                    options=SequentialOptions(), diagnostics=False,
                    device="cpu")
    sol = est.solve(Problem.single(tmodel, ts, y))
    assert sol.cost is None
    snap = obs.snapshot()
    # no instrument allocated but the executable cache's own counters, as
    # in the reference
    assert snap["histograms"] == {} and snap["gauges"] == {}
    assert snap["counters"] and all(k.startswith("cache.")
                                    for k in snap["counters"])
    assert obs.span_trees() == []


def test_ragged_solve_reports_padding_metrics():
    obs.enable()
    tmodel = _port_linear(wiener_velocity())
    rng = np.random.default_rng(0)
    records = []
    for n in (7, 12, 18, 25):
        ts = np.linspace(0.0, n / 32.0, n + 1)
        records.append((ts, rng.standard_normal((n, 2))))
    est = Estimator(tmodel, method="parallel_rts",
                    options=ParallelOptions(nsub=NSUB), device="cpu")
    sols = est.solve(Problem.ragged(tmodel, records))
    report = sols[0].padding
    snap = obs.snapshot()
    assert snap["counters"]["padding.records"] == 4
    assert snap["counters"]["padding.real_intervals"] == 7 + 12 + 18 + 25
    assert (snap["counters"]["padding.solved_intervals"]
            == report.solved_intervals)
    assert snap["gauges"]["padding.waste"] == pytest.approx(
        1.0 - report.interval_utilisation, abs=0)
    assert snap["counters"]["estimator.solves"] == len(report.buckets)


# -- parity with the reference's metrics --------------------------------------

# the port's counters that the reference lacks (module docstring)
PORT_ONLY_COUNTERS = ("cost.qpinv.once", "cost.qpinv.grid",
                      "scan.kernel.regs", "scan.kernel.wide")


def _normalised(snap):
    """Metric names by kind (the cache's and the fresh entry's ``compile``
    phase included)."""
    return {kind: sorted(snap[kind])
            for kind in ("counters", "gauges", "histograms")}


def _ragged_records(jmodel):
    out = []
    for i, n in enumerate((7, 12, 18, 25)):
        ts = time_grid(0.0, n / 20.0, n)
        _, y = jsimulate_linear(jmodel, ts, jax.random.PRNGKey(40 + i))
        out.append((np.asarray(ts), np.asarray(y)))
    return out


SCENARIOS = {
    "ragged": lambda jm, tm: (
        JEstimator(jm, method="parallel_rts",
                   options=JParallelOptions(nsub=NSUB, mode="discrete"),
                   cache=ExecutableCache()),
        Estimator(tm, method="parallel_kernel", device="cpu",
                  options=KernelOptions(nsub=NSUB, mode="discrete"),
                  cache=TExecutableCache())),
    "taylor": lambda jm, tm: (
        JEstimator(jm, method="parallel_rts", cache=ExecutableCache(),
                   options=JIteratedOptions(
                       inner=JParallelOptions(nsub=NSUB, mode="discrete"),
                       iterations=ITERS)),
        Estimator(tm, method="parallel_rts", device="cpu",
                  options=IteratedOptions(
                      inner=ParallelOptions(nsub=NSUB, mode="discrete"),
                      iterations=ITERS),
                  cache=TExecutableCache())),
    "sigma_point": lambda jm, tm: (
        JEstimator(jm, method="sigma_point", cache=ExecutableCache(),
                   options=JSigmaPointOptions(
                       inner=JParallelOptions(nsub=NSUB, mode="discrete"),
                       iterations=ITERS)),
        Estimator(tm, method="sigma_point", device="cpu",
                  options=SigmaPointOptions(
                      inner=ParallelOptions(nsub=NSUB, mode="discrete"),
                      iterations=ITERS),
                  cache=TExecutableCache())),
}


@pytest.fixture(scope="module")
def parity_runs():
    """Each scenario solved once by each package with its obs enabled;
    the two snapshots per scenario."""
    lin_j = wiener_velocity()
    lin_t = _port_linear(lin_j)
    ct_j = coordinated_turn()
    ct_t = _port_ct(ct_j)
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    _, y = jsimulate_nonlinear(ct_j, ts, jax.random.PRNGKey(0))
    ts, y = np.asarray(ts), np.asarray(y)
    ragged = _ragged_records(lin_j)
    out = {}
    was = (obs.enabled(), jobs.enabled())
    try:
        for name, make in SCENARIOS.items():
            models = (lin_j, lin_t) if name == "ragged" else (ct_j, ct_t)
            snaps = []
            for pkg, est, model, P in zip(
                    (jobs, obs), make(*models), models, (JProblem, Problem)):
                pkg.reset()
                pkg.enable()
                problem = (P.ragged(model, ragged) if name == "ragged"
                           else P.single(model, ts, y))
                est.solve(problem)
                snaps.append(pkg.snapshot())
                pkg.disable()
                pkg.reset()
            out[name] = dict(ref=snaps[0], port=snaps[1],
                             N=y.shape[0])
    finally:
        for o, w in zip((obs, jobs), was):
            (o.enable if w else o.disable)()
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_metric_names_match_reference(parity_runs, scenario):
    run = parity_runs[scenario]
    port = _normalised(run["port"])
    counters = run["port"]["counters"]
    if scenario == "ragged":           # linear, constant Q: one a solve
        assert counters["cost.qpinv.once"] == counters["estimator.solves"]
        assert "cost.qpinv.grid" not in counters
        # parallel_kernel on the CPU: the plain scan, no kernel launch
        assert not {"scan.kernel.regs", "scan.kernel.wide"} & set(counters)
    else:
        assert not set(PORT_ONLY_COUNTERS) & set(counters)
    port["counters"] = [n for n in port["counters"]
                        if n not in PORT_ONLY_COUNTERS]
    assert port == _normalised(run["ref"])


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_metric_values_match_reference(parity_runs, scenario):
    ref, port = parity_runs[scenario]["ref"], parity_runs[scenario]["port"]
    for name, value in ref["counters"].items():
        if name.startswith("linearize.slr."):
            continue
        assert port["counters"][name] == value, name
    for name, value in ref["gauges"].items():
        assert port["gauges"][name] == pytest.approx(value, rel=1e-12,
                                                     abs=0), name
    for name in ("estimator.final_cost", "nonlinear.cost_decrease",
                 "nonlinear.final_step_norm"):
        if name in ref["histograms"]:
            r, p = ref["histograms"][name], port["histograms"][name]
            assert p["count"] == r["count"], name
            assert p["sum"] == pytest.approx(r["sum"], rel=1e-9), name


def test_slr_counters_count_every_regression(parity_runs):
    """On a fresh entry the port's ``linearize.slr.*`` count the
    regressions performed: f and h at every interval's left point, each
    pass; the reference's count the same per traced call of its vmapped
    grid (two traced passes of a fresh executable: the scan body and the
    last pass)."""
    run = parity_runs["sigma_point"]
    N, S = run["N"], 2 * 5 + 1                 # unscented, nx = 5
    port, ref = run["port"]["counters"], run["ref"]["counters"]
    assert port["linearize.slr.regressions"] == 2 * ITERS * N
    assert port["linearize.slr.sigma_points"] == 2 * ITERS * N * S
    assert ref["linearize.slr.regressions"] == 2 * 2 * N
    assert ref["linearize.slr.sigma_points"] == 2 * 2 * N * S
