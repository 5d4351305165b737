"""The PyTorch port's executable cache and AOT path against the JAX
reference: ``ExecutableCache``, ``cache_stats``/``clear_cache``,
``Estimator(cache=...)``, ``Estimator.lower(problem).compile()``, the
per-entry counters, and the four small surface methods
(``SolverOptions.replace``, ``MethodSpec.default_options``,
``wiener_velocity.config``, ``configs.arch_module``).

Each cache test runs the same sequence of solves through both packages on
the same inputs and compares the hit/miss/eviction counts exactly and the
solutions to 1e-9 (a port ``Compiled`` entry and its ``solve`` bit for
bit).
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro import configs as jconfigs
from repro import obs as jobs
from repro.configs import wiener_velocity as jwiener
from repro.core import Estimator as JEstimator
from repro.core import ExecutableCache as JCache
from repro.core import IteratedOptions as JIteratedOptions
from repro.core import KernelOptions as JKernelOptions
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import SequentialOptions as JSequentialOptions
from repro.core import SigmaPointOptions as JSigmaPointOptions
from repro.core import cache_stats as jcache_stats
from repro.core import clear_cache as jclear_cache
from repro.core import get_method as jget_method
from repro.core import method_names as jmethod_names
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro.core import options as joptions
from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.configs import wiener_velocity as twiener
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.core import (
    DistributedOptions,
    Estimator,
    ExecutableCache,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    Problem,
    SequentialOptions,
    SigmaPointOptions,
    cache_stats,
    get_method,
    method_names,
)
from repro_torch.core import options as toptions
from repro_torch.distributed import MeshSpec

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB = 5
TOL = 1e-9
FIELDS = ("x", "S", "v", "cov", "cost")


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


@pytest.fixture(scope="module")
def wiener():
    """One model object per package (the caches key on it) and data."""
    jmodel = wiener_velocity()
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    _, y = jsimulate_linear(jmodel, ts, jax.random.PRNGKey(0))
    return dict(jmodel=jmodel, tmodel=_port_linear(jmodel),
                ts=np.asarray(ts), y=np.asarray(y))


def _stats(cache):
    return (cache.hits, cache.misses, cache.evictions, len(cache))


def _assert_bits(a, b, fields=FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


def _assert_close(tsol, jsol, fields=("x", "S", "v"), tol=TOL):
    for f in fields:
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)),
                                   rtol=tol, atol=tol, err_msg=f)


# ---------------------------------------------------------------------------
# the four surface methods
# ---------------------------------------------------------------------------


# KernelOptions.block_size is threads per CUDA block in the port (default
# 128) and lanes per Pallas grid step in the reference (default 512)
UNLIKE = {"block_size"}

OPTION_CASES = [
    ("SequentialOptions", {}, {"mode": "discrete"}),
    ("ParallelOptions", {"nsub": 7, "mode": "discrete"}, {"nsub": 3}),
    ("TwoFilterOptions", {"nsub": 4}, {"jitter": 1e-6, "mode": "rk4"}),
    ("KernelOptions", {"nsub": 4}, {"precision": "float64", "nsub": 2}),
    ("DistributedOptions", {"mode": "discrete"},
     {"time_axis": "t", "devices_per_time": 2}),
]


@pytest.mark.parametrize("name,init,changes", OPTION_CASES,
                         ids=[c[0] for c in OPTION_CASES])
def test_solver_options_replace_matches_reference(name, init, changes):
    """``SolverOptions.replace`` on the base class: every method's options
    take it, as in the reference (``ParallelOptions(...).replace(nsub=3)``
    failed in the port before)."""
    t = getattr(toptions, name)(**init).replace(**changes)
    j = getattr(joptions, name)(**init).replace(**changes)
    assert type(t).__name__ == name
    tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
    for k in tf.keys() & jf.keys() - UNLIKE:
        want = jf[k]
        if k == "batch_axes":
            want = tuple(want)
        assert tf[k] == want, k
    with pytest.raises(TypeError):
        getattr(toptions, name)().replace(no_such_field=1)
    with pytest.raises(ValueError):
        getattr(toptions, name)().replace(mode="bogus")


def test_method_spec_default_options_matches_reference():
    assert set(method_names()) == set(jmethod_names())
    for name in method_names():
        t, j = get_method(name).default_options(), \
            jget_method(name).default_options()
        assert type(t).__name__ == type(j).__name__, name
        assert t == get_method(name).options_cls(), name
        tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
        for k in tf.keys() & jf.keys() - UNLIKE - {"linearization",
                                                   "batch_axes"}:
            assert tf[k] == jf[k], (name, k)


def test_wiener_velocity_config_matches_reference():
    t, j = twiener.config(), jwiener.config()
    assert type(t).__name__ == type(j).__name__ == "WienerVelocityConfig"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    tm, jm = t.model(), j.model()
    for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def test_arch_module_matches_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for name in tconfigs.ARCHS:
        t, j = tconfigs.arch_module(name), jconfigs.arch_module(name)
        assert t.__name__.rsplit(".", 1)[1] == j.__name__.rsplit(".", 1)[1]
        assert dataclasses.asdict(t.config()) == dataclasses.asdict(
            j.config()), name
        assert dataclasses.asdict(t.smoke_config()) == dataclasses.asdict(
            j.smoke_config()), name
    for pkg in (tconfigs, jconfigs):
        with pytest.raises(KeyError):
            pkg.arch_module("no-such-arch")


# ---------------------------------------------------------------------------
# the reference's cache tests, each beside its reference
# ---------------------------------------------------------------------------


def test_lower_compile_aot(wiener):
    """``tests/test_estimator_api.py::test_lower_compile_aot``: the
    ``Compiled`` entry's solution is ``solve``'s, bit for bit; lowering
    builds the entry (a miss) and the later solve hits it, as in the
    reference; a ragged problem cannot be lowered."""
    w = wiener
    tc, jc = ExecutableCache(), JCache()
    est = Estimator(w["tmodel"], method="parallel_rts", device="cpu",
                    options=ParallelOptions(nsub=NSUB, mode="discrete"),
                    cache=tc)
    jest = JEstimator(w["jmodel"], method="parallel_rts", cache=jc,
                      options=JParallelOptions(nsub=NSUB, mode="discrete"))
    problem = Problem.single(w["tmodel"], w["ts"], w["y"])
    jproblem = JProblem.single(w["jmodel"], w["ts"], w["y"])
    compiled = est.lower(problem).compile()
    jcompiled = jest.lower(jproblem).compile()
    assert _stats(tc) == _stats(jc) == (0, 1, 0, 1)
    sol_aot = compiled(problem.ts, problem.y)
    sol = est.solve(problem)
    jsol_aot = jcompiled(jproblem.ts, jproblem.y)
    jsol = jest.solve(jproblem)
    _assert_bits(sol_aot, sol)
    _assert_close(sol_aot, jsol_aot)
    _assert_close(sol, jsol)
    assert _stats(tc) == _stats(jc) == (1, 1, 0, 1)
    recs = [(w["ts"], w["y"])]
    with pytest.raises(ValueError, match="ragged"):
        est.lower(Problem.ragged(w["tmodel"], recs))
    with pytest.raises(ValueError, match="ragged"):
        jest.lower(JProblem.ragged(w["jmodel"], recs))


def test_cache_distinguishes_mask_from_x_init():
    """``tests/test_estimator_api.py::test_cache_distinguishes_mask_from_x_init``:
    an ``(N,)`` mask and an ``(nx,)`` ``x_init`` of equal shape and dtype
    get two entries, and the warm-started solve equals a fresh private
    estimator's."""
    jmodel = coordinated_turn()                  # nx = 5
    tmodel = _port_ct(jmodel)
    ts = time_grid(0.0, 1.0, 5)                  # N = 5 == nx
    _, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(4))
    ts, y = np.asarray(ts), np.asarray(y)
    mask = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
    x0 = np.asarray(jmodel.m0)
    assert mask.shape == x0.shape and mask.dtype == x0.dtype

    def run(E, P, model, Opts, Seq, cache, stats, **kw):
        opts = Opts(iterations=2, inner=Seq(mode="euler"))
        est = E(model, method="sequential_rts", options=opts, **kw)
        before = stats()
        masked = est.solve(P.single(model, ts, y, measurement_mask=mask))
        warmed = est.solve(P.single(model, ts, y, x_init=x0))
        after = stats()
        fresh = E(model, method="sequential_rts", options=opts,
                  cache=cache, **kw).solve(P.single(model, ts, y, x_init=x0))
        return masked, warmed, fresh, after["misses"] - before["misses"]

    tm, tw, tf, tmiss = run(Estimator, Problem, tmodel, IteratedOptions,
                            SequentialOptions, ExecutableCache(), cache_stats,
                            device="cpu")
    jm, jw, jf, jmiss = run(JEstimator, JProblem, jmodel, JIteratedOptions,
                            JSequentialOptions, JCache(), jcache_stats)
    assert tmiss == jmiss == 2                   # two entries
    _assert_bits(tw, tf, ("x", "S", "v", "cost_trace"))
    assert not torch.equal(tm.x, tw.x)
    _assert_close(tm, jm, ("x", "S", "v", "cost_trace"), 1e-8)
    _assert_close(tw, jw, ("x", "S", "v", "cost_trace"), 1e-8)


def _linear_batch(B, seed):
    jmodel = wiener_velocity()
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    ys = jnp.stack([jsimulate_linear(jmodel, ts, k)[1] for k in keys])
    return jmodel, np.asarray(ts), np.asarray(ys)


def test_executable_cache_reuse():
    """``tests/test_batching.py::test_executable_cache_reuse`` through the
    default caches of both packages: the same shapes hit, a new shape
    misses, a second estimator with EQUAL options reuses the entry."""
    jmodel, ts, ys = _linear_batch(B=2, seed=40)
    tmodel = _port_linear(jmodel)

    def run(E, P, model, Opts, stats, **kw):
        opts = Opts(nsub=NSUB, mode="discrete")
        est = E(model, method="parallel_rts", options=opts, **kw)
        first = est.solve(P.stacked(model, ts, ys))
        seen = [stats()]
        est.solve(P.stacked(model, ts, ys * 2.0))       # same shapes
        seen.append(stats())
        est.solve(P.stacked(model, ts, ys[:1]))          # a new shape
        seen.append(stats())
        again = E(model, method="parallel_rts", options=Opts(
            nsub=NSUB, mode="discrete"), **kw).solve(P.stacked(model, ts, ys))
        seen.append(stats())
        deltas = [(s["hits"] - seen[0]["hits"],
                   s["misses"] - seen[0]["misses"]) for s in seen[1:]]
        return first, again, deltas

    t1, t2, tdeltas = run(Estimator, Problem, tmodel, ParallelOptions,
                          cache_stats, device="cpu")
    j1, j2, jdeltas = run(JEstimator, JProblem, jmodel, JParallelOptions,
                          jcache_stats)
    assert tdeltas == jdeltas == [(1, 0), (1, 1), (2, 1)]
    _assert_bits(t1, t2)
    _assert_close(t1, j1)


def test_solve_phases_and_cache_metrics(wiener):
    """``tests/test_obs.py::test_solve_phases_and_cache_metrics``: a fresh
    solve then a cached one give the same counters, histograms and span
    counts in both packages."""
    w = wiener
    jmodel = wiener_velocity()           # new model objects: a fresh entry
    snaps = []
    for pkg, E, P, model, Opts, stats, kw in (
            (jobs, JEstimator, JProblem, jmodel, JParallelOptions,
             jcache_stats, {}),
            (obs, Estimator, Problem, _port_linear(jmodel), ParallelOptions,
             cache_stats, {"device": "cpu"})):
        pkg.enable()
        est = E(model, method="parallel_rts", options=Opts(nsub=NSUB), **kw)
        problem = P.single(model, w["ts"], w["y"])
        before = stats()
        est.solve(problem)                       # fresh
        est.solve(problem)                       # cached
        after = stats()
        assert set(after) == {"size", "hits", "misses", "evictions"}
        snaps.append((pkg.snapshot(), after["misses"] - before["misses"],
                      after["hits"] - before["hits"]))
        pkg.disable()
    (jsnap, jmiss, jhit), (tsnap, tmiss, thit) = snaps
    assert (tmiss, thit) == (jmiss, jhit)
    assert tsnap["counters"] == jsnap["counters"]
    th, jh = tsnap["histograms"], jsnap["histograms"]
    for name in ("cache.compile_seconds", "span.estimator.solve",
                 "span.estimator.solve.prepare",
                 "span.estimator.solve.compile",
                 "span.estimator.solve.execute",
                 "span.estimator.solve.host_transfer"):
        assert th[name]["count"] == jh[name]["count"], name
    assert th["cache.compile_seconds"]["count"] == 1
    assert th["span.estimator.solve.compile"]["count"] == 1
    assert th["span.estimator.solve.execute"]["count"] == 1


def test_parallel_kernel_cache_key_bit_exact(wiener):
    """``tests/test_parallel_kernel.py::test_parallel_kernel_cache_key_bit_exact``:
    equal kernel options reuse one entry and give bit-identical arrays;
    distinct kernel options (``block_size``) are another entry with the
    same numerics."""
    w = wiener
    out = {}
    for name, E, P, model, Opts, stats, kw, bs, Cache in (
            ("ref", JEstimator, JProblem, w["jmodel"], JKernelOptions,
             jcache_stats, dict(interpret=True), 8, JCache),
            ("port", Estimator, Problem, w["tmodel"], KernelOptions,
             cache_stats, {}, 64, ExecutableCache)):
        dev = {} if name == "ref" else {"device": "cpu"}
        problem = P.single(model, w["ts"], w["y"] * 0.25)
        opts = Opts(nsub=NSUB, mode="discrete", **kw)
        a = E(model, method="parallel_kernel", options=opts,
              **dev).solve(problem)
        mid = stats()
        b = E(model, method="parallel_kernel",
              options=Opts(nsub=NSUB, mode="discrete", **kw),
              **dev).solve(problem)
        after = stats()
        private = Cache()
        c = E(model, method="parallel_kernel",
              options=opts.replace(block_size=bs), cache=private,
              **dev).solve(problem)
        out[name] = (a, b, c, after["misses"] - mid["misses"],
                     after["hits"] - mid["hits"], private.misses)
    (ja, jb, jc, *jcounts), (ta, tb, tc, *tcounts) = out["ref"], out["port"]
    assert tcounts == jcounts == [0, 1, 1]
    _assert_bits(ta, tb)
    assert float((ta.x - tc.x).abs().max()) < 1e-10
    _assert_close(ta, ja)


def test_parallel_kernel_lower_aot(wiener):
    """``tests/test_parallel_kernel.py::test_parallel_kernel_lower_aot``."""
    w = wiener
    est = Estimator(w["tmodel"], method="parallel_kernel", device="cpu",
                    options=KernelOptions(nsub=NSUB, mode="discrete"))
    jest = JEstimator(w["jmodel"], method="parallel_kernel",
                      options=JKernelOptions(nsub=NSUB, mode="discrete",
                                             interpret=True))
    problem = Problem.single(w["tmodel"], w["ts"], w["y"])
    jproblem = JProblem.single(w["jmodel"], w["ts"], w["y"])
    sol_aot = est.lower(problem).compile()(problem.ts, problem.y)
    jsol_aot = jest.lower(jproblem).compile()(jproblem.ts, jproblem.y)
    _assert_bits(sol_aot, est.solve(problem))
    _assert_close(sol_aot, jsol_aot)


# ---------------------------------------------------------------------------
# LRU, keys, signatures, per-entry counters
# ---------------------------------------------------------------------------


def test_lru_eviction_at_maxsize_2(wiener):
    """Three layouts through a cache of two entries, then the first layout
    again: the same hit/miss/eviction sequence in both packages."""
    w = wiener
    seqs = []
    for E, P, model, Opts, Cache, kw in (
            (JEstimator, JProblem, w["jmodel"], JParallelOptions, JCache, {}),
            (Estimator, Problem, w["tmodel"], ParallelOptions,
             ExecutableCache, {"device": "cpu"})):
        cache = Cache(maxsize=2)
        est = E(model, method="parallel_rts", cache=cache,
                options=Opts(nsub=NSUB, mode="discrete"), **kw)
        ys = np.stack([w["y"], 2 * w["y"], 3 * w["y"]])
        problems = [P.single(model, w["ts"], w["y"]),
                    P.stacked(model, w["ts"], ys[:2]),
                    P.stacked(model, w["ts"], ys),
                    P.single(model, w["ts"], w["y"]),
                    P.stacked(model, w["ts"], ys)]
        seq = []
        for p in problems:
            est.solve(p)
            seq.append(_stats(cache))
        seqs.append(seq)
        cache.clear()
        assert _stats(cache) == (0, 0, 0, 0)
    assert seqs[0] == seqs[1] == [(0, 1, 0, 1), (0, 2, 0, 2), (0, 3, 1, 2),
                                  (0, 4, 2, 2), (1, 4, 2, 2)]


def test_cache_keys_on_device_and_mesh(wiener):
    """The key holds the estimator's device and the resolved mesh: a
    ``cpu`` entry is not replayed for another device, nor for a mesh that
    repeats the device; the same device and mesh hit."""
    w = wiener
    cache = ExecutableCache()
    opts = ParallelOptions(nsub=NSUB, mode="discrete")
    problem = Problem.single(w["tmodel"], w["ts"], w["y"])
    cpu = Estimator(w["tmodel"], options=opts, device="cpu", cache=cache)
    first = cpu.lower(problem).compile()
    assert cpu.lower(problem).compile() is first
    # another device: lowering builds its own entry (nothing runs there)
    other = Estimator(w["tmodel"], options=opts, device="meta", cache=cache)
    assert other.lower(problem).compile() is not first
    mesh = MeshSpec(time=1, batch=2).build(["cpu"] * 2)
    meshed = Estimator(w["tmodel"], options=opts, mesh=mesh, cache=cache)
    stacked = Problem.stacked(w["tmodel"], w["ts"], np.stack([w["y"]] * 2))
    on_mesh = meshed.lower(stacked).compile()
    assert cpu.lower(stacked).compile() is not on_mesh
    assert (cache.hits, cache.misses) == (1, 4)
    _assert_bits(meshed.solve(stacked), cpu.solve(stacked))


def test_compiled_refuses_a_mismatched_call(wiener):
    """A ``Compiled`` entry takes the problem's arrays in the reference's
    order and refuses another shape, dtype or argument count, as a compiled
    JAX executable does."""
    w = wiener
    est = Estimator(w["tmodel"], options=ParallelOptions(nsub=NSUB),
                    device="cpu", cache=ExecutableCache())
    mask = np.ones(w["y"].shape[0])
    problem = Problem.single(w["tmodel"], w["ts"], w["y"],
                             measurement_mask=mask)
    compiled = est.lower(problem).compile()
    _assert_bits(compiled(w["ts"], w["y"], mask), est.solve(problem))
    ts, y = torch.tensor(w["ts"]), torch.tensor(w["y"])
    m = torch.tensor(mask)
    for args in ((ts, y), (ts, y, m, m), (ts[:-5], y[:-5], m[:-5]),
                 (ts, y.float(), m), (ts, y[:, :1], m)):
        with pytest.raises(ValueError, match="compiled signature"):
            compiled(*args)


def test_distributed_counters_count_per_entry():
    """``distributed.*`` count an entry's first run only, as the reference
    counts them while tracing a new executable: 2 sharded scans x 8
    shards on an 8 x cpu mesh (the reference's 8-device suite pins 16 for
    a fresh solve), nothing on a hit, and again on a new layout."""
    jmodel = wiener_velocity()
    ts = time_grid(0.0, 5.0, 480)
    _, y = jsimulate_linear(jmodel, ts, jax.random.PRNGKey(7))
    tmodel = _port_linear(jmodel)
    est = Estimator(tmodel, method="distributed", cache=ExecutableCache(),
                    options=DistributedOptions(nsub=NSUB, mode="discrete"),
                    mesh=MeshSpec(time=8).build(["cpu"] * 8))
    p = Problem.single(tmodel, np.asarray(ts), np.asarray(y))
    obs.enable()
    seen = []
    for problem in (p, p, Problem.stacked(tmodel, p.ts, p.y[None])):
        obs.reset()
        est.solve(problem)
        c = obs.snapshot()["counters"]
        seen.append((c.get("distributed.shards", 0),
                     c.get("distributed.carry_bytes", 0) > 0,
                     c.get("cache.hits", 0)))
    assert seen == [(16, True, 0), (0, False, 1), (16, True, 0)]


def test_slr_counters_zero_on_a_hit():
    """``linearize.slr.*`` count on a fresh entry and read 0 on a hit, in
    both packages (their fresh values differ by the documented rule:
    the reference counts traced call sites, the port regressions run)."""
    jmodel = coordinated_turn()
    tmodel = _port_ct(jmodel)
    ts = time_grid(0.0, 1.0, 4 * NSUB)
    _, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(0))
    ts, y = np.asarray(ts), np.asarray(y)
    iters, N, S = 3, y.shape[0], 2 * 5 + 1
    out = {}
    for name, pkg, E, P, model, Opts, Par, Cache, kw in (
            ("ref", jobs, JEstimator, JProblem, jmodel, JSigmaPointOptions,
             JParallelOptions, JCache, {}),
            ("port", obs, Estimator, Problem, tmodel, SigmaPointOptions,
             ParallelOptions, ExecutableCache, {"device": "cpu"})):
        est = E(model, method="sigma_point", cache=Cache(), **kw,
                options=Opts(inner=Par(nsub=NSUB, mode="discrete"),
                             iterations=iters))
        problem = P.single(model, ts, y)
        pkg.enable()
        counts = []
        for _ in range(2):
            pkg.reset()
            est.solve(problem)
            c = pkg.snapshot()["counters"]
            counts.append((c.get("linearize.slr.regressions", 0),
                           c.get("linearize.slr.sigma_points", 0)))
        pkg.disable()
        out[name] = counts
    assert out["ref"] == [(2 * 2 * N, 2 * 2 * N * S), (0, 0)]
    assert out["port"] == [(2 * iters * N, 2 * iters * N * S), (0, 0)]


def test_ragged_buckets_hit_on_a_repeat(wiener):
    """Each bucket of a ragged solve is one entry: a second solve of the
    same records hits every bucket, with the same counts as the
    reference's."""
    w = wiener
    rng = np.random.default_rng(0)
    records = []
    for n in (7, 12, 18, 25, 9):
        ts = np.linspace(0.0, n / 32.0, n + 1)
        records.append((ts, rng.standard_normal((n, 2))))
    counts = []
    sols = []
    for E, P, model, Opts, Cache, kw in (
            (JEstimator, JProblem, w["jmodel"], JParallelOptions, JCache, {}),
            (Estimator, Problem, w["tmodel"], ParallelOptions,
             ExecutableCache, {"device": "cpu"})):
        cache = Cache()
        est = E(model, method="parallel_rts", cache=cache,
                options=Opts(nsub=NSUB, mode="discrete"), **kw)
        first = est.solve(P.ragged(model, records))
        after_first = _stats(cache)
        second = est.solve(P.ragged(model, records))
        counts.append((after_first, _stats(cache),
                       len(first[0].padding.buckets)))
        sols.append((first, second))
    (jfirst, _), (tfirst, tsecond) = sols
    assert counts[0] == counts[1]
    buckets = counts[1][2]
    assert counts[1][:2] == ((0, buckets, 0, buckets),
                             (buckets, buckets, 0, buckets))
    for a, b, j in zip(tfirst, tsecond, jfirst):
        _assert_bits(a, b, ("x", "S", "v"))
        _assert_close(a, j)


def test_cache_counts_hold_under_concurrent_solves(wiener):
    """Threads solving two layouts through one estimator (as the engines'
    threads do): every lookup is a hit or a miss, one entry per layout,
    and every thread gets the single-threaded solution."""
    import sys
    import threading

    w = wiener
    cache = ExecutableCache()
    est = Estimator(w["tmodel"], options=ParallelOptions(nsub=NSUB),
                    device="cpu", cache=cache)
    problems = [Problem.single(w["tmodel"], w["ts"], w["y"]),
                Problem.stacked(w["tmodel"], w["ts"],
                                np.stack([w["y"], 2 * w["y"]]))]
    want = [Estimator(w["tmodel"], options=ParallelOptions(nsub=NSUB),
                      device="cpu", cache=ExecutableCache()).solve(p)
            for p in problems]
    threads, rounds, errors = 12, 4, []

    def work(i):
        try:
            for r in range(rounds):
                k = (i + r) % 2
                _assert_bits(est.solve(problems[k]), want[k])
        except Exception as exc:       # reported by the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors[0]
    assert (cache.misses, len(cache)) == (2, 2)
    assert cache.hits == threads * rounds - 2
