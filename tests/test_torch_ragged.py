"""Ragged records by pad-and-bucket in the PyTorch port, and the
deprecated function entry points, held against the JAX reference.

Both packages get the same numpy inputs: the reference's Wiener velocity
model and coordinated turn (carried across as numpy arrays) and records of
unequal lengths simulated by the reference, as in the reference's
``tests/test_batching.py`` and ``tests/test_deprecated_api.py``.
Tolerances are theirs, or tighter where the arithmetic is the same: masked
padding exact at 1e-9, ragged solves against the reference's at 1e-9,
against the unpadded sequential smoother at 1e-6, and the shims equal to
the ``Estimator`` solve they wrap bit for bit.  The port's
``parallel_kernel`` runs on the CPU through its kernel's plain version.
"""
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro.core import clear_cache as jclear_cache
from repro.core import Estimator as JEstimator
from repro.core import IteratedOptions as JIteratedOptions
from repro.core import MAPSolution as JMAPSolution
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import bucket_length as jbucket_length
from repro.core import pad_record as jpad_record
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import slice_solution as jslice_solution
from repro.core import time_grid
from repro_torch import core
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.distributed import MeshSpec
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    MAPSolution,
    ParallelOptions,
    Problem,
    SequentialOptions,
    bucket_length,
    get_solver,
    grid_lqt_from_linear,
    iterated_map,
    legacy_options,
    map_estimate,
    map_estimate_batched,
    map_estimate_ragged,
    method_names,
    pad_record,
    parallel_rts,
    registry,
    sequential_rts,
    slice_solution,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB = 5
TOL = 1e-9
LENGTHS = (12, 20, 35)          # buckets 20 (two records) and 40 (nsub 5)
METHODS = {"parallel_rts": ParallelOptions(nsub=NSUB, mode="discrete"),
           "parallel_kernel": KernelOptions(nsub=NSUB, mode="discrete")}


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_linear(jmodel):
    return linear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k))
         for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")})


def _port_ct(jmodel):
    ref = CoordinatedTurnConfig().model()
    return nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)


def _records(jmodel, lengths, seed, simulate=jsimulate_linear):
    out = []
    for i, n in enumerate(lengths):
        ts = time_grid(0.0, n / 20.0, n)
        _, y = simulate(jmodel, ts, jax.random.PRNGKey(seed + i))
        out.append((np.asarray(ts), np.asarray(y)))
    return out


@pytest.fixture(scope="module")
def lin():
    jmodel = wiener_velocity()
    return dict(jmodel=jmodel, tmodel=_port_linear(jmodel),
                records=_records(jmodel, LENGTHS, 30), memo={})


def _report(sols):
    return dataclasses.asdict(sols[0].padding)


# ---------------------------------------------------------------------------
# padding utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,nsub,sizes", [
    (1, 5, None), (5, 5, None), (6, 5, None), (11, 5, None), (95, 10, None),
    (2561, 10, None), (20480, 10, None), (7, 5, [10, 40]), (11, 5, [10, 40]),
    (50, 5, [10, 40]), (7, 5, [12])])
def test_bucket_length_matches_reference(N, nsub, sizes):
    try:
        want = jbucket_length(N, nsub, bucket_sizes=sizes)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            bucket_length(N, nsub, bucket_sizes=sizes)
    else:
        assert bucket_length(N, nsub, bucket_sizes=sizes) == want
        assert want % nsub == 0 and want >= N


@pytest.mark.parametrize("N,n_pad", [(10, 15), (10, 10), (1, 4), (7, 33)])
def test_pad_record_matches_reference(N, n_pad):
    rng = np.random.default_rng(N)
    ts = np.cumsum(rng.uniform(0.05, 0.2, N + 1))
    y = rng.standard_normal((N, 2))
    want = jpad_record(ts, y, n_pad)
    for ts_in, y_in in ((ts, y), (_t(ts), _t(y))):          # numpy or torch
        got = pad_record(ts_in, y_in, n_pad)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-15)


def test_pad_record_validation_mirrors_reference():
    ts, y = np.linspace(0.0, 1.0, 11), np.ones((10, 2))
    bad = [("at least one", (ts[:1], y[:0], 5)),
           ("points for", (ts[:-1], y, 15)),
           ("n_pad", (ts, y, 9)),
           ("strictly increasing", (np.r_[ts[:5], ts[4], ts[6:]], y, 15))]
    for match, args in bad:
        for fn in (pad_record, jpad_record):
            with pytest.raises(ValueError, match=match):
                fn(*args)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_masked_padding_is_exact(lin, method):
    """A masked tail beyond t_f leaves the real window unchanged."""
    tm = lin["tmodel"]
    ts, y = lin["records"][1]                      # N = 20
    N = y.shape[0]
    ts_p, y_p, mask = pad_record(ts, y, N + 3 * NSUB)
    est = Estimator(tm, method=method, device="cpu", options=METHODS[method])
    ref = est.solve(Problem.single(tm, ts, y))
    sol = est.solve(Problem.single(tm, ts_p, y_p, measurement_mask=mask))
    for f in ("x", "S", "v"):
        np.testing.assert_allclose(getattr(sol, f)[:N + 1].numpy(),
                                   getattr(ref, f).numpy(), rtol=0, atol=TOL,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# ragged solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", sorted(METHODS))
def test_ragged_matches_reference(lin, method):
    jm, tm = lin["jmodel"], lin["tmodel"]
    if "ref" not in lin["memo"]:
        lin["memo"]["ref"] = JEstimator(
            jm, method="parallel_rts",
            options=JParallelOptions(nsub=NSUB, mode="discrete")).solve(
            JProblem.ragged(jm, lin["records"]))
    want = lin["memo"]["ref"]
    got = Estimator(tm, method=method, device="cpu",
                    options=METHODS[method]).solve(
        Problem.ragged(tm, lin["records"]))
    assert [tuple(s.x.shape) for s in got] == [(n + 1, 4) for n in LENGTHS]
    for g, w in zip(got, want):
        for f in ("x", "S", "v", "cost"):
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(w, f)), rtol=TOL,
                                       atol=TOL, err_msg=f)
    assert _report(got) == _report(want)
    assert all(s.padding is got[0].padding for s in got)


def test_ragged_matches_unpadded_sequential(lin):
    """Each record against the nsub-free sequential smoother on the
    UNPADDED record (12 and 35 are not multiples of nsub; only bucketing
    makes them parallel-solvable); discrete mode is exact."""
    tm = lin["tmodel"]
    sols = Estimator(tm, method="parallel_kernel", device="cpu",
                     options=METHODS["parallel_kernel"]).solve(
        Problem.ragged(tm, lin["records"]))
    seq = Estimator(tm, method="sequential_rts", device="cpu",
                    options=SequentialOptions(mode="discrete"))
    for (ts, y), sol in zip(lin["records"], sols):
        ref = seq.solve(Problem.single(tm, ts, y))
        np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("layout", [
    dict(), dict(bucket_sizes=[40]), dict(bucket_sizes=[20, 40, 80]),
    dict(pad_batch=False, bucket_sizes=[40])])
def test_padding_report_matches_reference(lin, layout):
    """Buckets, batch rows (a batch of three records is padded to four by
    recycling its first record) and the utilisations."""
    jm, tm = lin["jmodel"], lin["tmodel"]
    recs = lin["records"]
    est = Estimator(tm, device="cpu", options=METHODS["parallel_rts"])
    got = est.solve(Problem.ragged(tm, recs, **layout))
    want = JEstimator(jm, options=JParallelOptions(
        nsub=NSUB, mode="discrete")).solve(JProblem.ragged(jm, recs, **layout))
    report = got[0].padding
    assert _report(got) == _report(want)
    assert report.lengths == LENGTHS and report.records == 3
    assert report.real_intervals == sum(LENGTHS)
    jr = want[0].padding
    for prop in ("solved_intervals", "interval_utilisation",
                 "row_utilisation"):
        assert getattr(report, prop) == getattr(jr, prop), prop
    assert [b.recycled_rows for b in report.buckets] == [
        b.recycled_rows for b in jr.buckets]
    default = est.solve(Problem.ragged(tm, recs))
    for a, b in zip(got, default):
        np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=0,
                                   atol=1e-6)


def test_nonlinear_ragged_per_record_warm_starts_and_priors():
    """Per-record ``x_init`` points and information-form priors ride into
    each bucket (recycled with their records) on the coordinated turn."""
    jm = coordinated_turn()
    tm = _port_ct(jm)
    recs = _records(jm, (9, 16, 23), 50, simulate=jsimulate_nonlinear)
    rng = np.random.default_rng(9)
    x_init = np.asarray(jm.m0)[None] + 0.05 * rng.standard_normal((3, 5))
    S0 = np.stack([np.diag(rng.uniform(20.0, 120.0, 5)) for _ in range(3)])
    v0 = np.einsum("bij,bj->bi", S0, x_init)
    kw = dict(x_init=x_init, prior=(S0, v0))
    want = JEstimator(jm, options=JIteratedOptions(
        inner=JParallelOptions(nsub=NSUB, mode="discrete"),
        iterations=3)).solve(JProblem.ragged(jm, recs, **kw))
    got = Estimator(tm, device="cpu", options=IteratedOptions(
        inner=ParallelOptions(nsub=NSUB, mode="discrete"),
        iterations=3)).solve(Problem.ragged(tm, recs, **kw))
    for g, w in zip(got, want):
        for f in ("x", "cost", "cost_trace", "step_norms"):
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(w, f)), rtol=TOL,
                                       atol=TOL, err_msg=f)
    assert _report(got) == _report(want)


def test_ragged_validation_mirrors_reference(lin):
    jm, tm = lin["jmodel"], lin["tmodel"]
    (ts, y), rec2 = lin["records"][0], lin["records"][1]
    bad = {
        "records must be non-empty": lambda P, m: P.ragged(m, []),
        "record 1: ts must be": lambda P, m: P.ragged(
            m, [(ts, y), (rec2[0][:-1], rec2[1])]),
        "record 0: y must be": lambda P, m: P.ragged(m, [(ts, y[0])]),
        "record 0: y has measurement dimension": lambda P, m: P.ragged(
            m, [(ts, y[:, :1])]),
        "only meaningful": lambda P, m: P.ragged(m, [(ts, y)],
                                                 x_init=np.zeros(4)),
        "prior": lambda P, m: P.ragged(m, [(ts, y)], prior=(np.eye(3),
                                                            np.zeros(3))),
    }
    for match, build in bad.items():
        for P, m in ((JProblem, jm), (Problem, tm)):
            with pytest.raises(ValueError, match=match):
                build(P, m)
    ctm = _port_ct(coordinated_turn())
    with pytest.raises(ValueError, match="ragged x_init"):
        Problem.ragged(ctm, [(ts, y)], x_init=np.zeros((2, 5)))


def test_layout_properties(lin):
    tm = lin["tmodel"]
    recs = lin["records"]
    ts, y = recs[1]
    assert Problem.single(tm, ts, y).lengths == (20,)
    stacked = Problem.stacked(tm, ts, np.stack([y, y, y]))
    assert stacked.lengths == (20,) * 3 and stacked.num_records == 3
    ragged = Problem.ragged(tm, recs, bucket_sizes=[40, 80])
    assert ragged.lengths == LENGTHS and ragged.num_records == 3
    assert ragged.kind == "ragged" and ragged.bucket_sizes == (40, 80)
    assert Estimator(tm, device="cpu",
                     options=METHODS["parallel_rts"]).block_size == NSUB
    assert Estimator(tm, method="sequential_rts", device="cpu").block_size == 1


# ---------------------------------------------------------------------------
# the deprecated entry points
# ---------------------------------------------------------------------------


def _same(old, new):
    olds = old if isinstance(old, list) else [old]
    news = new if isinstance(new, list) else [new]
    assert len(olds) == len(news)
    for o, n in zip(olds, news):
        for f in ("x", "S", "v"):
            torch.testing.assert_close(getattr(o, f), getattr(n, f), rtol=0,
                                       atol=0)
        assert o.padding == n.padding


@pytest.mark.parametrize("method", ["sequential_rts", "parallel_rts"])
def test_map_estimate_shim(lin, method):
    tm = lin["tmodel"]
    ts, y = lin["records"][1]
    with pytest.warns(DeprecationWarning, match="map_estimate"):
        old = map_estimate(tm, ts, y, method=method, nsub=NSUB,
                           mode="discrete", device="cpu")
    new = Estimator(tm, method=method, device="cpu",
                    options=registry.get_method(method).options_cls
                    .from_legacy(nsub=NSUB, mode="discrete")).solve(
        Problem.single(tm, ts, y))
    _same(old, new)


@pytest.mark.parametrize("shim", ["map_estimate", "iterated_map"])
def test_nonlinear_shims(shim):
    jm = coordinated_turn()
    tm = _port_ct(jm)
    (ts, y), = _records(jm, (20,), 1, simulate=jsimulate_nonlinear)
    kw = dict(method="parallel_rts", nsub=NSUB, mode="euler", iterations=3,
              device="cpu")
    with pytest.warns(DeprecationWarning, match=shim):
        old = {"map_estimate": map_estimate, "iterated_map": iterated_map}[
            shim](tm, ts, y, **kw)
    opts = legacy_options(tm, "parallel_rts", nsub=NSUB, mode="euler",
                          iterations=3)
    assert opts == IteratedOptions(inner=ParallelOptions(nsub=NSUB,
                                                         mode="euler"),
                                   iterations=3)
    new = Estimator(tm, device="cpu", options=opts).solve(
        Problem.single(tm, ts, y))
    _same(old, new)
    torch.testing.assert_close(old.cost_trace, new.cost_trace, rtol=0,
                               atol=0)


def test_map_estimate_batched_shim(lin):
    tm = lin["tmodel"]
    ts, y = lin["records"][1]
    ys = np.stack([y, 0.5 * y])
    with pytest.warns(DeprecationWarning, match="map_estimate_batched"):
        old = map_estimate_batched(tm, ts, ys, method="parallel_kernel",
                                   nsub=NSUB, mode="discrete", device="cpu")
    new = Estimator(tm, method="parallel_kernel", device="cpu",
                    options=METHODS["parallel_kernel"]).solve(
        Problem.stacked(tm, ts, ys))
    _same(old, new)


def test_map_estimate_ragged_shim(lin):
    tm = lin["tmodel"]
    with pytest.warns(DeprecationWarning, match="map_estimate_ragged"):
        old = map_estimate_ragged(tm, lin["records"], method="parallel_rts",
                                  nsub=NSUB, mode="discrete", device="cpu")
    new = Estimator(tm, device="cpu", options=METHODS["parallel_rts"]).solve(
        Problem.ragged(tm, lin["records"]))
    _same(old, new)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(batch_axis="data")])
def test_batched_shims_take_no_mesh(lin, kw):
    """The shims hand ``mesh``/``batch_axis`` to the Estimator: a mesh that
    is not ``None``, a ``Mesh`` or a ``MeshSpec`` raises ``as_mesh``'s
    ``TypeError``; ``batch_axis`` names the axis of a mesh of two CPU
    devices that splits the records, with the unsplit solve's result."""
    tm = lin["tmodel"]
    ts, y = lin["records"][1]
    ys = np.stack([y, 0.5 * y])
    if "mesh" in kw:
        for call in (lambda: map_estimate_batched(tm, ts, ys, device="cpu",
                                                  **kw),
                     lambda: map_estimate_ragged(tm, lin["records"],
                                                 device="cpu", **kw)):
            with pytest.warns(DeprecationWarning):
                with pytest.raises(TypeError, match="MeshSpec"):
                    call()
        return
    mesh = MeshSpec(batch=2).build(["cpu"] * 2)
    est = Estimator(tm, device="cpu", options=METHODS["parallel_rts"])
    with pytest.warns(DeprecationWarning, match="map_estimate_batched"):
        old = map_estimate_batched(tm, ts, ys, nsub=NSUB, mode="discrete",
                                   mesh=mesh, **kw)
    new = est.solve(Problem.stacked(tm, ts, ys))
    for f in ("x", "S", "v"):
        torch.testing.assert_close(getattr(old, f), getattr(new, f),
                                   rtol=1e-12, atol=1e-12)
    with pytest.warns(DeprecationWarning, match="map_estimate_ragged"):
        old = map_estimate_ragged(tm, lin["records"], nsub=NSUB,
                                  mode="discrete", mesh=mesh, **kw)
    new = est.solve(Problem.ragged(tm, lin["records"]))
    for o, n in zip(old, new):
        torch.testing.assert_close(o.x, n.x, rtol=1e-12, atol=1e-12)
    # buckets of one record solve two rows: the batch rounds up to the axis
    assert [b.batch for b in old[0].padding.buckets] == [2, 2]


def test_methods_is_a_live_view(monkeypatch):
    from repro_torch.core import api

    # registered after import (monkeypatch removes it again)
    monkeypatch.setitem(registry._METHODS, "_late_registered",
                        registry.MethodSpec("_late_registered", None,
                                            SequentialOptions))
    for module in (core, api):
        with pytest.warns(DeprecationWarning, match="METHODS"):
            live = module.METHODS
        assert "_late_registered" in live
    assert "_late_registered" in method_names()
    with pytest.raises(AttributeError):
        core.NO_SUCH_ATTRIBUTE


def test_get_solver(lin):
    """``get_solver`` is a ``(grid, nsub, mode)`` adapter around the
    registered solver."""
    tm = lin["tmodel"]
    ts, y = lin["records"][1]
    grid = grid_lqt_from_linear(tm, _t(ts), _t(y))
    for name, want in (
            ("sequential_rts", sequential_rts(grid, "discrete")),
            ("parallel_rts", parallel_rts(grid, NSUB, "discrete"))):
        got = get_solver(name)(grid, NSUB, "discrete")
        for f in ("x", "S", "v"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=0)
    with pytest.raises(ValueError, match="method must be one of"):
        get_solver("bogus")


def test_slice_solution_matches_reference():
    """``slice_solution`` on a ``Solution`` (record axis first) and on a
    ``MAPSolution`` (the port's time-first solver layout: records after
    time), against the reference's on the same numbers."""
    rng = np.random.default_rng(11)
    x, S, v = (rng.standard_normal(s) for s in ((2, 8, 3), (2, 8, 3, 3),
                                                 (2, 8, 3)))
    want = jslice_solution(JMAPSolution(x=x, S=S, v=v), 1, 5)
    got = slice_solution(MAPSolution(x=_t(x).movedim(0, 1),
                                     S=_t(S).movedim(0, 1),
                                     v=_t(v).movedim(0, 1)), 1, 5)
    assert isinstance(got, MAPSolution) and got.cov is None
    for f in ("x", "S", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    sol = core.Solution(x=_t(x), S=_t(S), v=_t(v), cost=_t(x[:, 0, 0]),
                        cost_trace=_t(x[:, :3, 0]))
    one = slice_solution(sol, 1, 5)
    assert tuple(one.x.shape) == (6, 3) and float(one.cost) == x[1, 0, 0]
    np.testing.assert_array_equal(one.cost_trace.numpy(), x[1, :3, 0])
    assert one.step_norms is None and one.padding is None


def test_core_surface_matches_reference():
    """The port's ``repro_torch.core`` exports the reference's
    ``repro.core`` surface, the executable cache included."""
    import repro.core as jcore

    missing = set(jcore.__all__) - set(core.__all__)
    assert not missing, sorted(missing)
    assert {"ExecutableCache", "cache_stats", "clear_cache"} <= set(
        core.__all__)


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
