"""Time-axis sharding (``method="distributed"``) and record-axis sharding
in the PyTorch port, held against the JAX reference.

The reference's own multi-device runs need forced host devices; the port
stands in for P devices with meshes that repeat the CPU device
(``MeshSpec.build(devices=["cpu"] * P)``), which run every shard's scan,
carry exchange and fix-up.  References:

* the port's ``distributed_scan`` against the reference's under
  ``jax.vmap(axis_name="time")`` over a ``(P, T/P, ...)`` reshape (the
  collectives run under ``vmap`` on one device), at round-off;
* the reference's ``parallel_rts`` at rtol/atol 1e-9 and
  ``sequential_rts`` at 1e-7, the bounds of its
  ``test_agreement_all_layouts_8_devices``;
* the reference's validation: the same exception types and messages.

Both packages get the same numpy inputs, simulated by the reference.
"""
import gc
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import coordinated_turn, wiener_velocity
from repro.core import DistributedOptions as JDistributedOptions
from repro.core import Estimator as JEstimator
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import SequentialOptions as JSequentialOptions
from repro.core import SigmaPointOptions as JSigmaPointOptions
from repro.core import clear_cache as jclear_cache
from repro.core import simulate_linear as jsimulate_linear
from repro.core import simulate_nonlinear as jsimulate_nonlinear
from repro.core import time_grid
from repro.core.combine import affine_combine as jaffine_combine
from repro.core.combine import lqt_combine as jlqt_combine
from repro.core.pscan import distributed_scan as jdistributed_scan
from repro.core.types import AffineElement as JAffineElement
from repro.core.types import LQTElement as JLQTElement
from repro.distributed import MeshSpec as JMeshSpec
from repro.distributed import as_mesh as jas_mesh
from repro.distributed import mesh_fingerprint as jmesh_fingerprint
from repro_torch import obs
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.convert import linear_sde_from_numpy, nonlinear_sde_from_numpy
from repro_torch.core import (
    AffineElement,
    DistributedOptions,
    Estimator,
    KernelOptions,
    LQTElement,
    ParallelOptions,
    Problem,
    SigmaPointOptions,
    affine_combine,
    distributed_scan,
    lqt_combine,
    method_names,
    prefix_scan,
    sharded_scan,
    suffix_scan,
)
from repro_torch.distributed import (
    Mesh,
    MeshSpec,
    as_mesh,
    data_parallel_size,
    mesh_context,
    mesh_fingerprint,
    resolve_time_mesh,
    shard_over_batch,
)
from repro_torch.serving import StreamingEngine, TrajectoryEngine

torch.set_num_threads(1)

TOL, SEQ_TOL = 1e-9, 1e-7
OPTS = DistributedOptions(mode="discrete")
POPTS = ParallelOptions(mode="discrete")


def cpu_mesh(time=1, batch=1):
    return MeshSpec(time=time, batch=batch).build(["cpu"] * (time * batch))


@pytest.fixture(autouse=True)
def _clean_obs():
    was = obs.enabled()
    obs.disable()
    obs.reset()
    yield
    obs.reset()
    (obs.enable if was else obs.disable)()


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


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def wiener():
    """The reference's 8-device agreement case: Wiener velocity (p0 = 1),
    520 intervals = 52 blocks + the terminal element, 53 % 8 != 0."""
    jmodel = wiener_velocity()
    ts = time_grid(0.0, 1.0, 520)
    _, y = jsimulate_linear(jmodel, ts, jax.random.PRNGKey(0))
    mask = (np.arange(520) % 3 != 0).astype(float)
    recs = []
    for N in (130, 250, 520):
        tsr = time_grid(0.0, 1.0, N)
        _, yr = jsimulate_linear(jmodel, tsr, jax.random.PRNGKey(N))
        recs.append((np.asarray(tsr), np.asarray(yr)))
    y = np.asarray(y)
    return dict(jmodel=jmodel, tmodel=_port_linear(jmodel),
                ts=np.asarray(ts), y=y, mask=mask,
                ys=np.stack([y, y * 1.1, y * 0.9, y + 0.1]),
                masks=np.stack([mask, 1 - mask, mask, np.ones(520)]),
                records=recs, memo={})


def _layout(w, layout, pkg):
    """The problem of ``layout`` built by either package."""
    P, m = (JProblem, w["jmodel"]) if pkg == "ref" else (Problem, w["tmodel"])
    ts, y = w["ts"], w["y"]
    if layout == "single":
        return P.single(m, ts, y)
    if layout == "masked":
        return P.single(m, ts, y, measurement_mask=w["mask"])
    if layout == "stacked":
        return P.stacked(m, ts, w["ys"], measurement_mask=w["masks"])
    return P.ragged(m, w["records"])


def _reference(w, layout, method):
    key = (layout, method)
    if key not in w["memo"]:
        opts = (JParallelOptions(mode="discrete") if method == "parallel_rts"
                else JSequentialOptions(mode="discrete"))
        sol = JEstimator(w["jmodel"], method=method, options=opts).solve(
            _layout(w, layout, "ref"))
        w["memo"][key] = ([np.asarray(s.x) for s in sol]
                          if layout == "ragged" else np.asarray(sol.x))
    return w["memo"][key]


def _xs(sol):
    return [s.x for s in sol] if isinstance(sol, list) else sol.x


# ---------------------------------------------------------------------------
# options, MeshSpec, as_mesh, mesh_fingerprint: the reference's validation
# ---------------------------------------------------------------------------


def test_method_registered():
    assert "distributed" in method_names()


@pytest.mark.parametrize("kw", [
    dict(time_axis=""), dict(batch_axes=("ok", "")),
    dict(time_axis="t", batch_axes=("t",)), dict(devices_per_time=0),
    dict(carry_dtype="bf16"), dict(fallback="maybe"), dict(nsub=0),
    dict(batch_axes="data"), dict(devices_per_time=1.5),
    dict(shard_count=4)])
def test_options_validation_matches_reference(kw):
    with pytest.raises((ValueError, TypeError)) as want:
        JDistributedOptions(**kw)
    with pytest.raises(want.type) as got:
        DistributedOptions(**kw)
    if want.type is ValueError:
        assert str(got.value) == str(want.value)


def test_options_defaults_match_reference():
    o, jo = DistributedOptions(), JDistributedOptions()
    for f in ("time_axis", "batch_axes", "devices_per_time", "carry_dtype",
              "fallback", "nsub", "mode"):
        assert getattr(o, f) == getattr(jo, f)
    assert o.resolve_carry_dtype() is None
    for name in ("float32", "float64"):
        got = DistributedOptions(carry_dtype=name).resolve_carry_dtype()
        want = JDistributedOptions(carry_dtype=name).resolve_carry_dtype()
        assert got == getattr(torch, name) and str(want) == name
    # the list form is normalised to a (hashable) tuple
    assert DistributedOptions(batch_axes=["b"]).batch_axes == ("b",)
    hash(DistributedOptions(batch_axes=["b"]))


@pytest.mark.parametrize("kw", [
    dict(time=0), dict(batch=-1), dict(time=2.0), dict(time_axis=""),
    dict(batch_axis=None), dict(time_axis="x", batch_axis="x")])
def test_meshspec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JMeshSpec(**kw)
    with pytest.raises(ValueError) as got:
        MeshSpec(**kw)
    assert str(got.value) == str(want.value)


def test_meshspec_build_and_as_mesh():
    spec = MeshSpec(time=2, batch=3)
    assert spec.num_devices == JMeshSpec(time=2, batch=3).num_devices == 6
    mesh = spec.build(["cpu"] * 6)
    assert mesh.shape == {"time": 2, "data": 3}
    assert mesh.axis_names == ("time", "data") == tuple(
        jas_mesh(JMeshSpec()).axis_names)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    # more devices than given -> the reference's error at build
    with pytest.raises(ValueError, match="needs 6 devices .2 x 3., only 1"):
        spec.build(device_type="cpu")
    with pytest.raises(ValueError, match="devices"):
        JMeshSpec(time=4096).build()
    # the default list: the one CPU device, or every card
    assert MeshSpec().build(device_type="cpu").devices.shape == (1, 1)
    assert MeshSpec().build(["cuda"]).devices[0, 0] == torch.device("cuda",
                                                                    0)
    assert as_mesh(None) is None and as_mesh(mesh) is mesh
    assert as_mesh(MeshSpec(), device_type="cpu").axis_names == (
        "time", "data")
    for bad in ("time:8", object()):
        with pytest.raises(TypeError, match="MeshSpec") as want:
            jas_mesh(bad)
        with pytest.raises(TypeError, match="MeshSpec") as got:
            as_mesh(bad)
        assert str(got.value).endswith(str(want.value).split(",")[-1])
    with pytest.raises(ValueError, match="one axis name per dimension"):
        Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("t",))


def test_mesh_fingerprint():
    assert mesh_fingerprint(None) is None is jmesh_fingerprint(None)
    fp = mesh_fingerprint(MeshSpec().build(device_type="cpu"))
    jfp = jmesh_fingerprint(JMeshSpec().build())
    assert fp[:3] == (("time", "data"), (1, 1), "cpu") == jfp[:3]
    assert mesh_fingerprint(MeshSpec().build(device_type="cpu")) == fp
    assert mesh_fingerprint(MeshSpec(time_axis="T").build(["cpu"])) != fp
    # a mesh that repeats a card differs from one of distinct cards
    rep = mesh_fingerprint(MeshSpec(time=2).build(["cuda:0"] * 2))
    dist = mesh_fingerprint(MeshSpec(time=2).build(["cuda:0", "cuda:1"]))
    assert rep == (("time", "data"), (2, 1), "cuda", (0, 0))
    assert dist[-1] == (0, 1) and rep != dist
    hash(fp)


def test_mesh_context_and_data_parallel_size():
    mesh = cpu_mesh(time=2, batch=4)
    assert data_parallel_size() == 1
    with mesh_context(mesh):
        assert data_parallel_size() == 4
        with MeshSpec(time=8).activate(["cpu"] * 8):
            assert data_parallel_size() == 1
            assert resolve_time_mesh("time", device_type="cpu").shape[
                "time"] == 8
        assert resolve_time_mesh("time", device_type="cpu") is mesh
    assert resolve_time_mesh("time", device_type="cpu") is None
    assert data_parallel_size(mesh) == 4      # the default axis, "data"


# ---------------------------------------------------------------------------
# distributed_scan against the reference's under vmap; sharded_scan
# ---------------------------------------------------------------------------


def _random_elems(kind, T, B, nx, seed):
    rng = np.random.default_rng(seed)

    def psd():
        L = rng.standard_normal((T, B, nx, nx)) * 0.4
        return L @ np.swapaxes(L, -1, -2) + 0.2 * np.eye(nx)

    if kind == "affine":
        return (rng.standard_normal((T, B, nx, nx)) * 0.5,
                rng.standard_normal((T, B, nx)))
    return (rng.standard_normal((T, B, nx, nx)) * 0.5,
            rng.standard_normal((T, B, nx)), psd(),
            rng.standard_normal((T, B, nx)), psd())


_PAIRS = {"affine": (AffineElement, affine_combine, JAffineElement,
                     jaffine_combine),
          "lqt": (LQTElement, lqt_combine, JLQTElement, jlqt_combine)}


@pytest.mark.parametrize("carry", [None, "float32"])
@pytest.mark.parametrize("kind,reverse", [("affine", False),
                                          ("affine", True), ("lqt", True)])
def test_distributed_scan_matches_reference(kind, reverse, carry):
    """P = 4 shards of 8 elements x 2 records: the reference's per-shard
    function under ``jax.vmap(axis_name="time")``, the port's over four
    shards on the CPU.  A float32 carry scan is the same arithmetic in
    another float32 library: it moves the result off the float64-carry
    one (by ~1e-7 here) and lands on the reference's to ~1e-8."""
    P, L, B, nx = 4, 8, 2, 3
    T, fn, JT, jfn = _PAIRS[kind]
    arrays = _random_elems(kind, P * L, B, nx, seed=len(kind) + reverse)
    jelems = JT(*(jnp.asarray(a.reshape((P, L) + a.shape[1:]))
                  for a in arrays))
    jcarry = None if carry is None else jnp.dtype(carry)
    want = jax.vmap(partial(jdistributed_scan, jfn, axis_name="time",
                            reverse=reverse, carry_dtype=jcarry),
                    axis_name="time")(jelems)
    shards = [T(*(torch.as_tensor(a[i * L:(i + 1) * L]) for a in arrays))
              for i in range(P)]
    got = distributed_scan(fn, shards, reverse=reverse,
                           carry_dtype=None if carry is None
                           else getattr(torch, carry))
    full = distributed_scan(fn, shards, reverse=reverse)
    tol = 1e-12 if carry is None else 1e-6
    moved = 0.0
    for k in range(len(arrays)):
        g = torch.stack([s[k] for s in got]).numpy()
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=tol,
                                   atol=tol)
        moved = max(moved, float(np.abs(
            g - torch.stack([s[k] for s in full]).numpy()).max()))
    if carry is None:
        assert moved == 0.0
    else:
        assert moved > 1e-12, "carry_dtype left the carry scan in float64"


def test_distributed_scan_lqt_prefix_matches_plain_scan():
    """The forward eq.-(42) scan (the reference's fix-up cannot broadcast
    its rank-reduced carry there; the port expands it) against the plain
    prefix scan."""
    P, L = 4, 6
    arrays = _random_elems("lqt", P * L, 2, 3, seed=7)
    elems = LQTElement(*(torch.as_tensor(a) for a in arrays))
    shards = [LQTElement(*(x[i * L:(i + 1) * L] for x in elems))
              for i in range(P)]
    got = distributed_scan(lqt_combine, shards)
    want = prefix_scan(lqt_combine, elems)
    for k in range(5):
        torch.testing.assert_close(torch.cat([s[k] for s in got]), want[k],
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("T", [64, 65, 67, 17, 8, 5])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_scan_on_cpu_meshes(P, T):
    """Divisible and non-divisible lengths (head + local tail) and the
    degrade cases (P < 2, T < 2P) against the plain scans, both
    directions, both combines (the reference's bound, 1e-9)."""
    mesh = cpu_mesh(time=P)
    for kind, directions in (("affine", (False, True)), ("lqt", (True,))):
        T_, fn = _PAIRS[kind][:2]
        elems = T_(*(torch.as_tensor(a) for a in
                     _random_elems(kind, T, 2, 3, seed=T + P)))
        for reverse in directions:
            got = sharded_scan(fn, elems, mesh=mesh, axis_name="time",
                               reverse=reverse)
            want = (suffix_scan if reverse else prefix_scan)(fn, elems)
            assert type(got) is type(elems)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)


def test_sharded_scan_float32_with_float64_carry():
    """The carry scan runs in ``carry_dtype`` (a spy on the combine sees
    float64 operands only then), and the result is cast back."""
    e32 = AffineElement(*(torch.as_tensor(a, dtype=torch.float32) for a in
                          _random_elems("affine", 64, 1, 4, seed=3)))

    def run(carry_dtype):
        seen = set()

        def spy(a, b):
            seen.add((a.Phi.dtype, b.Phi.dtype))
            return affine_combine(a, b)

        out = sharded_scan(spy, e32, mesh=cpu_mesh(time=8),
                           axis_name="time", carry_dtype=carry_dtype)
        return out, seen

    got, seen = run(torch.float64)
    assert got.Phi.dtype == torch.float32
    assert seen == {(torch.float32, torch.float32),
                    (torch.float64, torch.float64)}
    plain, seen = run(None)
    assert seen == {(torch.float32, torch.float32)}
    assert not torch.equal(got.Phi, plain.Phi)
    want = prefix_scan(affine_combine, e32)
    torch.testing.assert_close(got.Phi, want.Phi, rtol=1e-4, atol=1e-4)


def test_sharded_scan_counts_and_span():
    """Every sharded scan run outside a cache entry counts its shards and
    carry bytes and opens the span; a degraded scan counts nothing."""
    elems = AffineElement(*(torch.as_tensor(a) for a in
                            _random_elems("affine", 20, 2, 3, seed=1)))
    obs.enable()
    for _ in range(2):
        sharded_scan(affine_combine, elems, mesh=cpu_mesh(time=4),
                     axis_name="time")
    sharded_scan(affine_combine, elems, mesh=cpu_mesh(time=1),
                 axis_name="time")
    snap = obs.snapshot(include_trees=True)
    assert snap["counters"]["distributed.shards"] == 8
    # per scan: 4 carries of (2 records x (3x3 + 3)) float64
    assert snap["counters"]["distributed.carry_bytes"] == 2 * 4 * 2 * 12 * 8
    assert [t["name"] for t in snap["span_trees"]] == ["distributed_scan"] * 2


# ---------------------------------------------------------------------------
# method="distributed": the reference's 8-device agreement suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["single", "masked", "stacked", "ragged"])
def test_agreement_all_layouts_8_devices(wiener, layout):
    """8 x cpu mesh: the reference's ``parallel_rts`` at 1e-9 and
    ``sequential_rts`` at 1e-7; two sharded scans of 8 shards per stacked
    solve (one per bucket of a ragged solve)."""
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    mesh=cpu_mesh(time=8))
    assert est.device == torch.device("cpu")
    obs.enable()
    sol = est.solve(_layout(w, layout, "port"))
    got = _xs(sol)
    for method, tol in (("parallel_rts", TOL), ("sequential_rts", SEQ_TOL)):
        want = _reference(w, layout, method)
        for g, r in zip(got if layout == "ragged" else [got],
                        want if layout == "ragged" else [want]):
            _close(g, r, tol)
    solves = len(sol[0].padding.buckets) if layout == "ragged" else 1
    assert obs.snapshot()["counters"]["distributed.shards"] == 16 * solves
    if layout == "ragged":
        assert all(s.padding is not None for s in sol)


def test_distributed_counts_and_span_per_solve(wiener):
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    mesh=cpu_mesh(time=8))
    p = _layout(w, "single", "port")
    obs.enable()
    est.solve(p)
    snap = obs.snapshot(include_trees=True)
    c = snap["counters"]
    assert c["distributed.shards"] == 16 and c["distributed.carry_bytes"] > 0
    names = set()

    def walk(nodes):
        for nd in nodes:
            names.add(nd["name"])
            walk(nd.get("children", []))

    walk(snap["span_trees"])
    assert {"estimator.solve.compile", "distributed_scan"} <= names
    est.solve(p)                     # a cache hit counts nothing more
    c = obs.snapshot()["counters"]
    assert c["distributed.shards"] == 16 and c["cache.hits"] == 1


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_on_smaller_meshes(wiener, P):
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    mesh=cpu_mesh(time=P))
    _close(est.solve(_layout(w, "stacked", "port")).x,
           _reference(w, "stacked", "parallel_rts"))


def test_ambient_mesh_and_float32_carry(wiener):
    """``MeshSpec.activate`` reaches an Estimator that holds no mesh; a
    float64 carry scan keeps a float32 solve's dtype."""
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    device="cpu")
    p = _layout(w, "single", "port")
    with MeshSpec(time=4).activate(["cpu"] * 4):
        obs.enable()
        _close(est.solve(p).x, _reference(w, "single", "parallel_rts"))
        assert obs.snapshot()["counters"]["distributed.shards"] == 8
    m32 = w["tmodel"].to(dtype=torch.float32)
    e32 = Estimator(m32, method="distributed", mesh=cpu_mesh(time=4),
                    options=DistributedOptions(mode="discrete",
                                               carry_dtype="float64"))
    x32 = e32.solve(Problem.single(m32, w["ts"], w["y"])).x
    assert x32.dtype == torch.float32
    ref = _reference(w, "single", "parallel_rts")
    assert np.abs(x32.numpy() - ref).max() < 1e-2 * np.abs(ref).max()


def test_ambient_time_mesh_beside_a_time_less_estimator_mesh(wiener):
    """An Estimator that holds a mesh without the time axis, inside an
    ambient time mesh: the solve resolves the mesh once and the solver
    runs on that one (the ambient mesh's 4 shards), not on a mesh
    resolved a second time."""
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    mesh=MeshSpec(time=1, batch=2, time_axis="t").build(
                        ["cpu"] * 2))
    with MeshSpec(time=4).activate(["cpu"] * 4):
        obs.enable()
        _close(est.solve(_layout(w, "stacked", "port")).x,
               _reference(w, "stacked", "parallel_rts"))
        assert obs.snapshot()["counters"]["distributed.shards"] == 8


def test_fallback_and_errors_match_reference(wiener):
    """One device (the default list here): ``fallback="auto"`` IS the
    parallel solver, bit for bit; ``"error"`` raises; ``devices_per_time``
    beyond the devices raises "exceeds", and against a mesh of another
    extent raises, in both packages."""
    w = wiener
    tm, jm = w["tmodel"], w["jmodel"]
    p, jp = _layout(w, "single", "port"), _layout(w, "single", "ref")
    sd = Estimator(tm, method="distributed", options=OPTS,
                   device="cpu").solve(p)
    sp = Estimator(tm, options=POPTS, device="cpu").solve(p)
    for f in ("x", "S", "v"):
        torch.testing.assert_close(getattr(sd, f), getattr(sp, f), rtol=0,
                                   atol=0)
    cases = [(dict(fallback="error"), RuntimeError, "needs >= 2 devices"),
             (dict(devices_per_time=2), ValueError, "exceeds")]
    for kw, exc, match in cases:
        with pytest.raises(exc, match=match) as want:
            JEstimator(jm, method="distributed",
                       options=JDistributedOptions(**kw)).solve(jp)
        with pytest.raises(exc, match=match) as got:
            Estimator(tm, method="distributed", device="cpu",
                      options=DistributedOptions(**kw)).solve(p)
        assert str(got.value) == str(want.value)
    bad = Estimator(tm, method="distributed", device="cpu",
                    options=DistributedOptions(mode="discrete",
                                               devices_per_time=2))
    with MeshSpec(time=8).activate(["cpu"] * 8):
        with pytest.raises(ValueError, match="devices_per_time=2 but the "
                                             "mesh's 'time' axis has size 8"):
            bad.solve(p)
    with pytest.raises(ValueError, match="not the mesh's first device"):
        Estimator(tm, method="distributed", device="cuda",
                  mesh=cpu_mesh(time=2))
    with pytest.raises(ValueError, match="needs 2 devices"):
        Estimator(tm, method="distributed", device="cpu",
                  mesh=MeshSpec(time=2))


# ---------------------------------------------------------------------------
# the 2-D (time x batch) mesh and the batch split
# ---------------------------------------------------------------------------


def test_2d_mesh_stacked_and_not_divisible(wiener):
    """``MeshSpec(time=4, batch=2)``: batch chunk j runs its time shards on
    column j; 2 P shards counted per chunk.  A batch the axis does not
    divide raises the reference's error."""
    w = wiener
    est = Estimator(w["tmodel"], method="distributed", options=OPTS,
                    mesh=cpu_mesh(time=4, batch=2))
    obs.enable()
    _close(est.solve(_layout(w, "stacked", "port")).x,
           _reference(w, "stacked", "parallel_rts"))
    assert obs.snapshot()["counters"]["distributed.shards"] == 2 * 8
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh "
                                         "batch axis size 2"):
        est.solve(Problem.stacked(w["tmodel"], w["ts"], w["ys"][:3]))


@pytest.mark.parametrize("pad_batch,rows", [(True, [2, 2, 2]),
                                            (False, [2, 2, 2])])
def test_2d_mesh_ragged_rounds_bucket_batch(wiener, pad_batch, rows):
    """Each bucket's batch rounds up to a multiple of the batch axis (the
    reference's ``estimator.py:843-846``), here one record -> 2 rows."""
    w = wiener
    tm = w["tmodel"]
    est = Estimator(tm, method="distributed", options=OPTS,
                    mesh=cpu_mesh(time=4, batch=2))
    sols = est.solve(Problem.ragged(tm, w["records"], pad_batch=pad_batch))
    assert [b.batch for b in sols[0].padding.buckets] == rows
    for g, r in zip(_xs(sols), _reference(w, "ragged", "parallel_rts")):
        _close(g, r)


def test_ragged_batch_rounds_to_batch_axis_of_three(wiener):
    """Buckets of 3 / 1 records on a batch axis of 3: pad_batch=False
    gives 3 / 3 rows, pad_batch=True next_pow2 then the axis: 6 / 3."""
    w = wiener
    tm = w["tmodel"]
    recs = [w["records"][0]] * 3 + [w["records"][1]]
    est = Estimator(tm, options=POPTS, mesh=cpu_mesh(batch=3))
    for pad_batch, rows in ((False, [3, 3]), (True, [6, 3])):
        sols = est.solve(Problem.ragged(tm, recs, pad_batch=pad_batch))
        assert [b.batch for b in sols[0].padding.buckets] == rows
    ref = Estimator(tm, options=POPTS, device="cpu").solve(
        Problem.ragged(tm, recs))
    for a, b in zip(sols, ref):
        torch.testing.assert_close(a.x, b.x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method,options", [
    ("parallel_rts", POPTS),
    ("parallel_kernel", KernelOptions(mode="discrete")),
    ("sequential_rts", None)])
def test_batch_sharding_non_distributed_methods(wiener, method, options):
    """``mesh=MeshSpec(batch=4)`` splits the records of any method (the
    reference's ``shard_over_batch``), with per-record masks; the time
    axis of the mesh is ignored by non-distributed methods."""
    w = wiener
    tm = w["tmodel"]
    p = _layout(w, "stacked", "port")
    want = Estimator(tm, method=method, options=options,
                     device="cpu").solve(p)
    for mesh in (cpu_mesh(batch=4), cpu_mesh(time=2, batch=2)):
        got = Estimator(tm, method=method, options=options,
                        mesh=mesh).solve(p)
        for f in ("x", "S", "v", "cost"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=1e-12, atol=1e-12)
    # another batch_axis name: the mesh's "data" axis no longer splits
    with pytest.raises(ValueError, match="not divisible"):
        Estimator(tm, method=method, options=options,
                  mesh=cpu_mesh(batch=4)).solve(
            Problem.stacked(tm, w["ts"], w["ys"][:2]))
    Estimator(tm, method=method, options=options, mesh=cpu_mesh(batch=4),
              batch_axis="rows").solve(
        Problem.stacked(tm, w["ts"], w["ys"][:2]))


def test_shard_over_batch_splits_and_joins():
    """Record dims split per ``in_axes`` (tuples share their entry, None
    is shared, non-tensors pass), each shard is handed the sub-mesh of
    its batch index, and the results join along dim 0."""
    mesh = cpu_mesh(time=2, batch=3)
    seen = []

    def fn(flag, a, shared, pair, *, mesh):
        seen.append((tuple(a.shape), mesh.shape))
        return (a.T + shared, pair[0] * flag, pair[1])

    a = torch.arange(24.0).reshape(4, 6)
    out = shard_over_batch(fn, mesh, "data", (None, 1, None, 0))(
        2, a, torch.ones(1), (torch.arange(6.0), None))
    assert seen == [((4, 2), {"time": 2, "data": 1})] * 3
    torch.testing.assert_close(out[0], a.T + 1)
    torch.testing.assert_close(out[1], 2 * torch.arange(6.0))
    assert out[2] is None
    with pytest.raises(ValueError, match="batch 4 not divisible by mesh "
                                         "batch axis size 3"):
        shard_over_batch(fn, mesh, "data", (None, 0, None, 0))(
            1, a, torch.ones(1), (torch.arange(4.0), None))


def test_shard_over_batch_takes_the_reference_booleans():
    """The reference's call form (``arg_batched=[True, False]``: the first
    argument split on dim 0, the second shared; a ``fn`` without a
    ``mesh`` keyword): the same outputs as the ``[0, None]`` form and as
    the reference's ``shard_over_batch`` (its ``shard_map`` over the batch
    axis, on the one device of this process); a mix of booleans and dims
    raises a TypeError that names both forms."""
    from repro.distributed.sharding import shard_over_batch as j_sob

    rng = np.random.default_rng(5)
    a, w = rng.standard_normal((8, 3)), rng.standard_normal((3, 2))
    mesh = cpu_mesh(batch=4)
    seen = []

    def fn(x, y):
        seen.append(tuple(x.shape))
        return x @ y, (x.sum(-1), y)

    got = shard_over_batch(fn, mesh, "data", [True, False])(
        torch.from_numpy(a), torch.from_numpy(w))
    assert seen == [(2, 3)] * 4
    dims = shard_over_batch(lambda x, y, *, mesh: fn(x, y), mesh, "data",
                            [0, None])(torch.from_numpy(a),
                                       torch.from_numpy(w))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rows",))
    want = j_sob(lambda x, y: x @ y, jmesh, "rows", [True, False])(
        jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    assert torch.equal(got[0], dims[0]) and torch.equal(got[1][0],
                                                        dims[1][0])
    # every output joins over the shards, as out_specs=P(batch) joins them
    assert got[1][1].shape == (12, 2)
    with pytest.raises(TypeError, match="booleans .* int dim or None"):
        shard_over_batch(fn, mesh, "data", [True, None])


# ---------------------------------------------------------------------------
# the engines with a mesh
# ---------------------------------------------------------------------------


_RECORDS = {}


def _record(N, seed):
    if (N, seed) not in _RECORDS:
        ts = time_grid(0.0, N / 20.0, N)
        _, y = jsimulate_linear(wiener_velocity(), ts,
                                jax.random.PRNGKey(seed))
        _RECORDS[(N, seed)] = (np.asarray(ts), np.asarray(y))
    return _RECORDS[(N, seed)]


def test_sharded_batch_path(wiener):
    """The reference's ``test_trajectory_engine.py::test_sharded_batch_path``:
    waves of 2 x the batch axis go through the split."""
    tm = wiener["tmodel"]
    mesh = cpu_mesh(batch=2)
    engine = TrajectoryEngine(tm, batch=2 * mesh.shape["data"], mesh=mesh,
                              options=ParallelOptions(nsub=5,
                                                      mode="discrete"))
    recs = [_record(20, 50 + i) for i in range(3)]
    sols = engine.estimate(recs)
    par = JEstimator(wiener["jmodel"], method="parallel_rts",
                     options=JParallelOptions(nsub=5, mode="discrete"))
    for (ts, y), sol in zip(recs, sols):
        ref = par.solve(JProblem.single(wiener["jmodel"], ts, y))
        np.testing.assert_allclose(sol.x, ref.x, atol=1e-6, rtol=0)


def test_trajectory_engine_distributed_2d_mesh(wiener):
    """The reference's engine on the unified mesh: ``distributed`` over
    ``MeshSpec(time=4, batch=2)``, and ``parallel_kernel`` waves split
    over the batch axis: each at 1e-9 of the reference's solve."""
    w = wiener
    tm = w["tmodel"]
    recs = [(w["ts"], w["y"]), (w["ts"], w["y"] * 1.1)]
    engines = {
        "distributed": TrajectoryEngine(tm, batch=2, method="distributed",
                                        options=OPTS,
                                        mesh=cpu_mesh(time=4, batch=2)),
        "parallel_kernel": TrajectoryEngine(
            tm, batch=4, method="parallel_kernel",
            options=KernelOptions(mode="discrete"), mesh=cpu_mesh(batch=2))}
    ref = JEstimator(w["jmodel"], method="parallel_rts",
                     options=JParallelOptions(mode="discrete"))
    want = [np.asarray(ref.solve(JProblem.single(w["jmodel"], ts, y)).x)
            for ts, y in recs]
    for name, eng in engines.items():
        sols = eng.estimate(recs)
        assert eng.waves == 1
        for sol, x in zip(sols, want):
            _close(sol.x, x)


def test_streaming_engine_with_mesh():
    """A ``StreamingEngine`` whose waves split over a batch axis of 2
    gives the unsplit engine's windows (1e-12) and the offline solve's
    final states (1e-9 x scale)."""
    jmodel = wiener_velocity()
    tm = _port_linear(jmodel)
    N, tracks = 60, 4
    ts = time_grid(0.0, N / 10.0, N)
    ys = [np.asarray(jsimulate_linear(jmodel, ts, jax.random.PRNGKey(s))[1])
          for s in range(tracks)]
    ts = np.asarray(ts)
    opts = ParallelOptions(nsub=5, mode="discrete")

    def run(**kw):
        eng = StreamingEngine(tm, lag=20, batch=4, options=opts, **kw)
        tids = [eng.open_track(ts[0]) for _ in ys]
        for i in range(0, N, 15):
            for tid, y in zip(tids, ys):
                eng.push(tid, ts[i + 1:i + 16], y[i:i + 15])
            eng.run()
        return eng, [eng.estimate(t).x.numpy() for t in tids]

    eng, split = run(mesh=cpu_mesh(batch=2))
    assert eng.estimator.mesh.shape["data"] == 2
    _, whole = run(device="cpu")
    offline = Estimator(tm, options=opts, device="cpu")
    for k, (a, b) in enumerate(zip(split, whole)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        ref = offline.solve(Problem.single(tm, ts, ys[k])).x.numpy()
        scale = np.abs(ref).max()
        assert np.abs(a[-21:] - ref[-21:]).max() < 1e-9 * scale


# ---------------------------------------------------------------------------
# sigma point with inner_method="distributed"
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ct():
    jmodel = coordinated_turn()
    ts = time_grid(0.0, 2.5, 100)
    _, y = jsimulate_nonlinear(jmodel, ts, jax.random.PRNGKey(2))
    ref = CoordinatedTurnConfig().model()
    tmodel = nonlinear_sde_from_numpy(
        {k: np.asarray(getattr(jmodel, k)) for k in ("Q", "R", "m0", "P0")},
        ref.f, ref.h)
    return dict(jmodel=jmodel, tmodel=tmodel, ts=np.asarray(ts),
                y=np.asarray(y))


def test_sigma_point_distributed_inner_fallback(ct):
    """The reference's ``test_linearize.py``: ``inner_method="distributed"``
    on one device degrades to the parallel scan and matches the
    ``parallel_rts`` inner at 1e-10 -- in both packages; on a 4 x cpu
    mesh the time-sharded inner agrees too (1e-9)."""
    tm, jm = ct["tmodel"], ct["jmodel"]
    dopts = dict(inner_method="distributed",
                 inner=DistributedOptions(nsub=10, mode="discrete"))
    popts = dict(inner=ParallelOptions(nsub=10, mode="discrete"))
    p = Problem.single(tm, ct["ts"], ct["y"])
    dist = Estimator(tm, method="sigma_point", device="cpu",
                     options=SigmaPointOptions(**dopts)).solve(p)
    ref = Estimator(tm, method="sigma_point", device="cpu",
                    options=SigmaPointOptions(**popts)).solve(p)
    _close(dist.x, ref.x, 1e-10)
    jp = JProblem.single(jm, ct["ts"], ct["y"])
    jdist = JEstimator(jm, method="sigma_point", options=JSigmaPointOptions(
        inner_method="distributed",
        inner=JDistributedOptions(nsub=10, mode="discrete"))).solve(jp)
    _close(dist.x, jdist.x, 1e-9)
    obs.enable()
    sharded = Estimator(tm, method="sigma_point", mesh=cpu_mesh(time=4),
                        options=SigmaPointOptions(**dopts)).solve(p)
    _close(sharded.x, ref.x)
    # 5 passes x 2 sharded scans x 4 shards
    assert obs.snapshot()["counters"]["distributed.shards"] == 40
