"""Per-module parity of the PyTorch port (``repro_torch.core``) with the
JAX reference (``repro.core``) at float64.

Both packages get the same inputs, made with numpy from a seed or taken
from the reference's own simulated measurements, and must agree to
round-off (rtol 1e-10): the port keeps the reference's combine order (the
same associative-scan tree) and its arithmetic up to LAPACK round-off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_ltv, wiener_velocity
from repro.core import combine as jcombine
from repro.core import elements as jelements
from repro.core import parallel as jparallel
from repro.core import pscan as jpscan
from repro.core import sde as jsde
from repro.core import sequential as jsequential
from repro.core.types import AffineElement as JAffine
from repro.core.types import LQTElement as JElem
from repro.core.types import ValueFn as JValue
from repro_torch.convert import (
    elements_from_numpy,
    grid_from_numpy,
    linear_sde_from_numpy,
)
from repro_torch.core import combine as tcombine
from repro_torch.core import elements as telements
from repro_torch.core import parallel as tparallel
from repro_torch.core import pscan as tpscan
from repro_torch.core import sde as tsde
from repro_torch.core import sequential as tsequential
from repro_torch.core.types import (
    AffineElement,
    GridLQT,
    LQTElement,
    MAPSolution,
    Solution,
    ValueFn,
)

torch.set_num_threads(1)

RTOL = 1e-10
NSUB = 4
N = 24


def _close(got, want, rtol=RTOL, atol=1e-12):
    """Field-wise comparison of a port tuple/tensor with a JAX one."""
    if isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)
        return
    assert len(tuple(got)) == len(tuple(want))
    for g, w in zip(tuple(got), tuple(want)):
        if w is None:
            assert g is None
        else:
            _close(g, w, rtol, atol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _psd(rng, B, n):
    A = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", A, A) / n + 0.1 * np.eye(n)


def _rand_elems(rng, B, n):
    return (rng.standard_normal((B, n, n)) * 0.6, rng.standard_normal((B, n)),
            _psd(rng, B, n), rng.standard_normal((B, n)), _psd(rng, B, n))


def _both(arrs):
    """The same numpy element tuple as a JAX and a port LQTElement."""
    return (JElem(*map(jnp.asarray, arrs)),
            elements_from_numpy(arrs))


# The reference runs jitted: one XLA program per shape instead of an
# eager compile per primitive keeps this module fast.
_j_par = jax.jit(functools.partial(jparallel.parallel_rts, nsub=NSUB,
                                   mode="discrete"))
_j_seq = jax.jit(functools.partial(jsequential.sequential_rts,
                                   mode="discrete"))
_j_back = jax.jit(functools.partial(jparallel.parallel_backward, nsub=NSUB,
                                    mode="discrete"))
_j_cost = jax.jit(jsde.om_cost_grid)


def _measurements(seed, n, ny=2):
    """Seeded numpy measurements (any data makes a valid linear problem)."""
    rng = np.random.default_rng(seed)
    return 5.0 + rng.standard_normal((n, ny))


def _sde_arrays(model):
    return {k: np.asarray(getattr(model, k))
            for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")}


@pytest.fixture(scope="module")
def wiener_case():
    """Reference model, grid and measurements (N = 24) for both packages."""
    model = wiener_velocity()
    ts = jsde.time_grid(0.0, 1.2, N)
    y = jnp.asarray(_measurements(1, N))
    rng = np.random.default_rng(3)
    mask = (rng.random(N) > 0.3).astype(np.float64)
    tmodel = linear_sde_from_numpy(_sde_arrays(model))
    return model, tmodel, ts, y, mask


def _grids(case, mask=None, prior=None):
    model, tmodel, ts, y, _ = case
    jmask = None if mask is None else jnp.asarray(mask)
    jprior = None if prior is None else tuple(map(jnp.asarray, prior))
    jg = jsde.grid_lqt_from_linear(model, ts, y, measurement_mask=jmask,
                                   prior=jprior)
    tg = tsde.grid_lqt_from_linear(
        tmodel, _t(ts), _t(y),
        measurement_mask=None if mask is None else _t(mask),
        prior=None if prior is None else tuple(map(_t, prior)))
    return jg, tg


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


def test_types_mirror_reference_fields():
    for port, ref in ((LQTElement, JElem), (AffineElement, JAffine),
                      (ValueFn, JValue)):
        assert port._fields == ref._fields
    from repro.core.types import GridLQT as JGrid
    from repro.core.types import MAPSolution as JSol

    assert GridLQT._fields == JGrid._fields
    assert MAPSolution._fields == JSol._fields
    e = elements_from_numpy(_rand_elems(np.random.default_rng(0), 5, 3))
    assert len(e) == 5 and e.nx == 3
    sol = Solution(x=torch.zeros(3, 2), S=torch.zeros(3, 2, 2),
                   v=torch.zeros(3, 2))
    assert sol.cov is None and sol.cost is None
    with pytest.raises(AttributeError):
        sol.x = None


# ---------------------------------------------------------------------------
# combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_combines_match_reference(n):
    rng = np.random.default_rng(10 + n)
    j1, t1 = _both(_rand_elems(rng, 6, n))
    j2, t2 = _both(_rand_elems(rng, 6, n))
    _close(tcombine.lqt_combine(t1, t2), jax.jit(jcombine.lqt_combine)(j1, j2))

    Phi = rng.standard_normal((2, 6, n, n))
    beta = rng.standard_normal((2, 6, n))
    _close(tcombine.affine_combine(AffineElement(_t(Phi[0]), _t(beta[0])),
                                   AffineElement(_t(Phi[1]), _t(beta[1]))),
           jcombine.affine_combine(JAffine(Phi[0], beta[0]),
                                   JAffine(Phi[1], beta[1])))

    S, v = _psd(rng, 6, n), rng.standard_normal((6, n))
    _close(tcombine.apply_element_to_value(t1, ValueFn(_t(S), _t(v))),
           jax.jit(jcombine.apply_element_to_value)(j1, JValue(S, v)))
    _close(tcombine.value_as_element(ValueFn(_t(S), _t(v))),
           jcombine.value_as_element(JValue(S, v)))


def test_combine_broadcasts_shared_operand_over_records():
    """A shared (nx, nx) operand combines with per-record (R, nx, nx)
    ones -- the shape of a shared prior in a stacked solve."""
    rng = np.random.default_rng(4)
    arrs = _rand_elems(rng, 3, 3)
    shared = elements_from_numpy([a[0] for a in _rand_elems(rng, 1, 3)])
    recs = elements_from_numpy(arrs)
    got = tcombine.lqt_combine(recs, shared)
    for r in range(3):
        one = tcombine.lqt_combine(LQTElement(*(a[r] for a in recs)), shared)
        for g, w in zip(got, one):
            torch.testing.assert_close(g[r], w, rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# pscan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 2, 5, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_scans_match_reference(T, reverse):
    """Same tree as ``jax.lax.associative_scan`` -> round-off parity, for
    power-of-two and odd lengths, both orientations and the sequential
    folds."""
    rng = np.random.default_rng(100 + T)
    je, te = _both(_rand_elems(rng, T, 3))
    jscan = jpscan.suffix_scan if reverse else jpscan.prefix_scan
    tscan = tpscan.suffix_scan if reverse else tpscan.prefix_scan
    want = jax.jit(functools.partial(jscan, jcombine.lqt_combine))(je)
    _close(tscan(tcombine.lqt_combine, te), want)
    _close(tscan(tcombine.lqt_combine, te, sequential=True),
           jax.jit(functools.partial(jscan, jcombine.lqt_combine,
                                     sequential=True))(je))
    _close(tscan(tcombine.lqt_combine, te, sequential=True), want,
           rtol=1e-9, atol=1e-10)


def test_suffix_scan_keeps_operand_order():
    """A non-commutative combine: the suffix scan must hand the EARLIER
    element to ``fn`` first (the flip + swap of the reference)."""
    rng = np.random.default_rng(7)
    Phi, beta = rng.standard_normal((6, 2, 2)), rng.standard_normal((6, 2))
    els = AffineElement(_t(Phi), _t(beta))
    got = tpscan.suffix_scan(tcombine.affine_combine, els)
    want = jpscan.suffix_scan(jcombine.affine_combine, JAffine(Phi, beta))
    _close(got, want)


# ---------------------------------------------------------------------------
# sde
# ---------------------------------------------------------------------------


def test_time_grid_defaults_to_float64():
    ts = tsde.time_grid(0.0, 1.0, 8)
    assert ts.dtype == torch.float64 and ts.shape == (9,)
    _close(ts, jsde.time_grid(0.0, 1.0, 8), rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("variant", ["plain", "mask", "prior"])
def test_grid_and_costs_match_reference(wiener_case, variant):
    model, tmodel, ts, y, mask = wiener_case
    m = mask if variant == "mask" else None
    prior = None
    if variant == "prior":
        rng = np.random.default_rng(5)
        prior = (_psd(rng, 1, 4)[0] * 3.0, rng.standard_normal(4))
    jg, tg = _grids(wiener_case, mask=m, prior=prior)
    _close(tg, jg)
    x = np.asarray(_j_par(jg).x)
    x = x + 0.01 * np.random.default_rng(6).standard_normal(x.shape)
    _close(tsde.om_cost_grid(tg, _t(x)), _j_cost(jg, x))
    jprior = None if prior is None else tuple(map(jnp.asarray, prior))
    _close(tsde.om_cost_linear(
        tmodel, _t(ts), _t(y), _t(x),
        measurement_mask=None if m is None else _t(m),
        prior=None if prior is None else tuple(map(_t, prior))),
        jsde.om_cost_linear(model, ts, y, x,
                            measurement_mask=None if m is None
                            else jnp.asarray(m), prior=jprior))


def test_om_cost_grid_pinv_cutoff_on_singular_q():
    """Wiener velocity's Q is singular (q_jitter = 0): the pseudo-inverse
    cutoff must be the reference's (10 max(m, n) eps)."""
    from repro.configs.wiener_velocity import WienerVelocityConfig as JCfg
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig

    jmodel = JCfg().model()
    tmodel = WienerVelocityConfig().model()
    for f in ("F", "c", "H", "r", "Q", "R", "m0", "P0"):
        _close(getattr(tmodel, f), getattr(jmodel, f), rtol=0, atol=0)
    ts = jsde.time_grid(0.0, 0.5, N)
    y = jnp.asarray(_measurements(2, N))
    jg = jsde.grid_lqt_from_linear(jmodel, ts, y)
    tg = tsde.grid_lqt_from_linear(tmodel, _t(ts), _t(y))
    x = np.asarray(_j_par(jg).x) + 0.05
    _close(tsde.om_cost_grid(tg, _t(x)), _j_cost(jg, x))


def test_time_varying_model_through_vmap():
    """Callable coefficients are evaluated with ``torch.func.vmap`` on the
    grid; rebuilt from the reference's own random draws."""
    key = jax.random.PRNGKey(11)
    jmodel = random_ltv(key)
    ks = jax.random.split(key, 6)
    A = np.asarray(jax.random.normal(ks[0], (3, 3)) * 0.3)
    Bm = np.asarray(jax.random.normal(ks[1], (3, 3)) * 0.2)
    cvec = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64)
    np.testing.assert_allclose(np.asarray(jmodel.F(0.7)),
                               A + Bm * np.sin(0.7), rtol=1e-14)
    arrs = {k: np.asarray(getattr(jmodel, k))
            for k in ("H", "r", "Q", "R", "m0", "P0")}
    arrs["F"] = lambda t: _t(A) + _t(Bm) * torch.sin(t)
    arrs["c"] = lambda t: cvec * torch.cos(t)
    tmodel = linear_sde_from_numpy(arrs)
    ts = jsde.time_grid(0.0, 1.0, 12)
    y = jnp.asarray(_measurements(3, 12))
    _close(tsde.grid_lqt_from_linear(tmodel, _t(ts), _t(y)),
           jsde.grid_lqt_from_linear(jmodel, ts, y))


def test_simulate_linear_shapes_and_generator():
    tmodel = linear_sde_from_numpy(_sde_arrays(wiener_velocity()))
    ts = tsde.time_grid(0.0, 1.0, 10)
    g = torch.Generator().manual_seed(0)
    xs, y = tsde.simulate_linear(tmodel, ts, g)
    assert xs.shape == (11, 4) and y.shape == (10, 2)
    xs2, y2 = tsde.simulate_linear(tmodel, ts,
                                   torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    xb, yb = tsde.simulate_linear(tmodel, ts[:, None].expand(-1, 3), g)
    assert xb.shape == (11, 3, 4) and yb.shape == (10, 3, 2)
    assert torch.isfinite(yb).all()


# ---------------------------------------------------------------------------
# elements
# ---------------------------------------------------------------------------


def test_elements_match_reference(wiener_case):
    jg, tg = _grids(wiener_case, mask=wiener_case[4])
    _close(telements.one_step_elements(tg), jelements.one_step_elements(jg))
    _close(telements.terminal_element(tg), jelements.terminal_element(jg))
    _close(telements.identity_element(4, torch.float64),
           jelements.identity_element(4, jnp.float64))
    _close(telements._block_view(tg, NSUB), jelements._block_view(jg, NSUB))
    _close(telements._lin_term(tg), jelements._lin_term(jg))
    jb, js = jelements.discrete_block_elements(jg, NSUB)
    tb, tsub = telements.discrete_block_elements(tg, NSUB)
    _close(tb, jb)
    _close(tsub, js)
    rng = np.random.default_rng(8)
    T = N // NSUB
    S, v = _psd(rng, T, 4), rng.standard_normal((T, 4))
    _close(telements.backward_value_fill_discrete(tsub, ValueFn(_t(S), _t(v))),
           jelements.backward_value_fill_discrete(js, JValue(S, v)))


def test_block_view_rejects_indivisible_grid(wiener_case):
    _, tg = _grids(wiener_case)
    with pytest.raises(ValueError, match="not divisible"):
        telements._block_view(tg, 5)


# ---------------------------------------------------------------------------
# sequential / parallel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "mask", "prior"])
def test_solvers_match_reference(wiener_case, variant):
    prior = None
    if variant == "prior":
        rng = np.random.default_rng(9)
        prior = (_psd(rng, 1, 4)[0] * 5.0, rng.standard_normal(4))
    jg, tg = _grids(wiener_case,
                    mask=wiener_case[4] if variant == "mask" else None,
                    prior=prior)
    jv = jsequential.sequential_backward(jg, "discrete")
    _close(tsequential.sequential_backward(tg, "discrete"), jv)
    _close(tsequential.affine_recovery_maps(tg, ValueFn(_t(jv.S), _t(jv.v)),
                                            "discrete"),
           jsequential.affine_recovery_maps(jg, jv, "discrete"))
    tseq = tsequential.sequential_rts(tg, "discrete")
    _close(tseq, _j_seq(jg))

    jvals, jbnd, _, _ = _j_back(jg)
    tvals, tbnd, _, _ = tparallel.parallel_backward(tg, NSUB, "discrete")
    _close(tvals, jvals)
    _close(tbnd, jbnd)
    tpar = tparallel.parallel_rts(tg, NSUB, "discrete")
    _close(tpar, _j_par(jg))
    # the discrete-mode exactness claim: parallel == sequential
    assert float((tpar.x - tseq.x).abs().max()) < 1e-8
    torch.testing.assert_close(tpar.S, tseq.S, rtol=1e-9, atol=1e-8)


def test_parallel_carries_record_dims(wiener_case):
    """A grid with a record dim after the time axis solves every record
    exactly as its own single-record grid does."""
    model, tmodel, ts, y, _ = wiener_case
    ys = np.stack([np.asarray(y), np.asarray(y) * 0.9 + 0.1])      # (2,N,ny)
    tts = _t(ts)[:, None].expand(-1, 2)
    tg = tsde.grid_lqt_from_linear(tmodel, tts, _t(ys).movedim(0, 1))
    both = tparallel.parallel_rts(tg, NSUB, "discrete")
    for r in range(2):
        one = tparallel.parallel_rts(
            tsde.grid_lqt_from_linear(tmodel, _t(ts), _t(ys[r])), NSUB,
            "discrete")
        torch.testing.assert_close(both.x[:, r], one.x, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", ["euler", "rk4"])
def test_unported_modes_raise(wiener_case, mode):
    _, tg = _grids(wiener_case)
    for call in (lambda: tparallel.parallel_rts(tg, NSUB, mode),
                 lambda: tsequential.sequential_rts(tg, mode)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError, match="unknown element mode"):
        tparallel.parallel_rts(tg, NSUB, "bogus")


def test_grid_rejects_mismatched_record_dims(wiener_case):
    _, tmodel, ts, y, _ = wiener_case
    with pytest.raises(ValueError, match="record dims"):
        tsde.grid_lqt_from_linear(tmodel, _t(ts), _t(y)[:, None].expand(
            -1, 2, -1))


def test_convert_round_trip(wiener_case):
    jg, _ = _grids(wiener_case)
    tg = grid_from_numpy({k: None if v is None else np.asarray(v)
                          for k, v in jg._asdict().items()})
    _close(tg, jg, rtol=0, atol=0)
    tg2 = grid_from_numpy(jg)
    _close(tg2, jg, rtol=0, atol=0)
    e = elements_from_numpy(_rand_elems(np.random.default_rng(1), 4, 2),
                            dtype=torch.float32)
    assert e.A.dtype == torch.float32 and e.A.device.type == "cpu"
