"""Lorenz-96 at N = 40 (``repro_torch.configs.lorenz96``) on the CPU: the
port's iterated smoother against the plain one (``plain_lorenz96.py``),
the drift's Jacobian, and the scan's dispatch by state width to the wide
kernel's entry (on the CPU its plain version) with its launch counters.
"""
import pytest
import torch

import plain_lorenz96 as plain
from repro_torch import obs
from repro_torch.configs import lorenz96
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    Problem,
    time_grid,
)
from repro_torch.core.types import LQTElement
from repro_torch.kernels.lqt_combine import ops as tops
from repro_torch.kernels.lqt_combine import scan as tscan

# torch's forward-mode AD (the Taylor linearisation) loads its
# decompositions through ``torch.jit.script``, which torch marks deprecated
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

RECORDS, STEPS, NSUB = 2, 60, 10
# Both sides are float64 and solve the same backward-Euler problem in each
# of the 5 passes, so they differ by round-off alone: the port's
# information-form scan against a covariance-form filter, each pass's
# difference carried into the next linearisation.  Measured 6.3e-15 of the
# largest state here; 1e-10 leaves four orders for the attractor's
# stretching, and float32 reads ~1e-6 (the control below).
TOL = 1e-10


def gap(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def problem():
    cfg = lorenz96.config()
    model = cfg.model()
    dt = (cfg.tf - cfg.t0) / (512 * cfg.nsub)
    y = plain.simulate(model.m0, model.P0, model.Q, model.R, dt,
                       cfg.forcing, RECORDS, STEPS,
                       torch.Generator().manual_seed(96))
    want = plain.iterated_smoother(y, model.m0, model.P0, model.Q, model.R,
                                   dt, cfg.forcing, cfg.iterations)
    ts = time_grid(cfg.t0, cfg.t0 + STEPS * dt, STEPS)
    return cfg, ts, y, want


def port_solve(cfg, ts, y, method, inner, dtype=torch.float64):
    model = cfg.model(dtype=dtype)
    est = Estimator(model, method=method, device="cpu",
                    options=IteratedOptions(inner=inner,
                                            iterations=cfg.iterations))
    return est.solve(Problem.stacked(model, ts.to(dtype),
                                     y.to(dtype))).x.double()


@pytest.mark.parametrize("method,inner", [
    ("parallel_rts", ParallelOptions(nsub=NSUB, mode="discrete")),
    ("parallel_kernel", KernelOptions(nsub=NSUB, mode="discrete"))],
    ids=["parallel_rts", "parallel_kernel"])
def test_port_matches_plain_smoother(problem, method, inner):
    cfg, ts, y, want = problem
    got = port_solve(cfg, ts, y, method, inner)
    assert got.shape == want.shape == (RECORDS, STEPS + 1, 40)
    assert gap(got, want) < TOL


def test_float32_control_fails_the_tolerance(problem):
    cfg, ts, y, want = problem
    got = port_solve(cfg, ts, y, "parallel_kernel",
                     KernelOptions(nsub=NSUB, mode="discrete"),
                     dtype=torch.float32)
    assert gap(got, want) > 10 * TOL


def test_drift_jacobian_is_the_hand_jacobian():
    cfg = lorenz96.config()
    model = cfg.model()
    x = torch.randn(7, 40, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3)) * 4 + 2
    got = torch.func.vmap(torch.func.jacfwd(lambda z: model.f(z, None)))(x)
    torch.testing.assert_close(got, plain.f_jacobian(x), rtol=0, atol=1e-13)
    torch.testing.assert_close(model.f(x[0], None), plain.f(x[0], 8.0),
                               rtol=0, atol=1e-13)
    assert model.m0.shape == (40,) and model.ny == 20


def elems(nx, n=5, rec=(3,)):
    g = torch.Generator().manual_seed(nx)

    def r(*s):
        return torch.randn((n,) + rec + s, dtype=torch.float64, generator=g)

    def psd():
        a = r(nx, nx)
        return a @ a.mT / nx + 0.1 * torch.eye(nx, dtype=torch.float64)

    return LQTElement(r(nx, nx) * 0.6, r(nx), psd(), r(nx), psd())


def test_scan_dispatches_wide_states_to_the_wide_entry(monkeypatch):
    calls = []
    for name in ("lqt_scan", "lqt_scan_wide"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda e, _n=name, _r=real, **kw: (
            calls.append((_n, e.A.shape[-1])), _r(e, **kw))[1])
    for nx in (4, 8, 9, 40):
        e = elems(nx)
        got = tops.kernel_suffix_scan(e)
        want = tscan.lqt_scan_ref(e, reverse=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert calls == [("lqt_scan", 4), ("lqt_scan", 8),
                     ("lqt_scan_wide", 9), ("lqt_scan_wide", 40)]


def test_block_folds_of_wide_states_take_the_pairwise_entry(problem,
                                                           monkeypatch):
    """``parallel_kernel`` folds each block's substep elements, steps its
    values and maps the trajectory's recovery with the core's own steps up
    to nx 8 and with the wide kernel's pairwise entry above (on the CPU
    its plain version, the core combine itself), which give the core's
    results."""
    from repro_torch.core.combine import apply_element_to_value, lqt_combine
    from repro_torch.core.elements import CORE_STEPS, discrete_recovery_maps
    from repro_torch.core.types import ValueFn

    assert tops.in_block_steps(8) is CORE_STEPS
    wide = tops.in_block_steps(9)
    assert wide is tops.WIDE_STEPS
    assert wide.fold is tscan.lqt_combine_wide
    a, b = elems(40, n=4, rec=(2,)), elems(40, n=4, rec=(2,))
    b = LQTElement(*(x.flip(0) for x in b))
    for x, y in zip(wide.fold(a, b), lqt_combine(a, b)):
        assert torch.equal(x, y)
    value = ValueFn(b.J, b.eta)
    for x, y in zip(wide.value_step(a, value),
                    apply_element_to_value(a, value)):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    for x, y in zip(wide.recovery_maps(a.A, a.b, a.C, b.J, b.eta),
                    discrete_recovery_maps(a.A, a.b, a.C, b.J, b.eta)):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="differ in shape"):
        tscan.lqt_combine_wide(a, LQTElement(*(x[:2] for x in b)))
    with pytest.raises(ValueError, match="lqt_combine_wide kernel takes"):
        tscan.lqt_combine_wide(elems(8), elems(8))
    calls = []

    def counted(kind, fn):
        def step(first, *rest):
            A = first.A if isinstance(first, LQTElement) else first
            calls.append((kind, tuple(A.shape)))
            return fn(first, *rest)
        return step

    monkeypatch.setattr(tops, "WIDE_STEPS", tops.InBlockSteps(
        *(counted(k, f) for k, f in zip(tops.InBlockSteps._fields,
                                        tops.WIDE_STEPS))))
    cfg, ts, y, _ = problem
    port_solve(cfg, ts, y, "parallel_kernel",
               KernelOptions(nsub=NSUB, mode="discrete"))
    T = STEPS // NSUB
    # a pass: nine fold steps, ten value steps, the recovery's maps
    blocks, points = (T, RECORDS, 40, 40), (STEPS, RECORDS, 40, 40)
    assert calls == ([("fold", blocks)] * (NSUB - 1)
                     + [("value_step", blocks)] * NSUB
                     + [("recovery_maps", points)]) * cfg.iterations
def test_wide_entry_refuses_what_its_kernel_does_not_take():
    for nx in (1, 8, tscan.NX_WIDE + 1):
        with pytest.raises(ValueError, match=r"lqt_scan_wide kernel takes "
                           rf"9 <= nx <= {tscan.NX_WIDE}, got {nx}"):
            tscan.lqt_scan_wide(elems(nx, n=2))
    e = elems(tscan.NX_WIDE, n=2, rec=())
    assert tscan._check(e, 9, tscan.NX_WIDE) == (2, (), tscan.NX_WIDE)
    # NX_WIDE is the widest float64 combine a block's shared memory holds
    assert tscan.wide_smem_bytes(tscan.NX_WIDE, 8) <= tscan.SMEM_BYTES
    assert tscan.wide_smem_bytes(tscan.NX_WIDE + 1, 8) > tscan.SMEM_BYTES
    assert tscan.wide_smem_bytes(40, 8) == 79056
    assert [tscan.wide_launches(n) for n in (1, 2, 3, 17, 513)] == [
        1, 2, 2, 7, 17]


def test_scan_counters_count_launches_by_path(problem):
    """Telemetry on: the launch counters ``scan.kernel.regs`` and
    ``scan.kernel.wide`` count where a kernel launches, on the card
    (``tests/test_torch_gpu.py``); on the CPU every scan, narrow or wide,
    and the whole Lorenz-96 solve run the plain version and count none."""
    obs.disable()
    obs.reset()
    obs.enable()
    try:
        tops.kernel_suffix_scan(elems(5, n=17))
        tops.kernel_prefix_scan(elems(12, n=17))
        tops.kernel_prefix_scan(elems(12, n=0))
        cfg, ts, y, _ = problem
        port_solve(cfg, ts, y, "parallel_kernel",
                   KernelOptions(nsub=NSUB, mode="discrete"))
        counters = obs.snapshot()["counters"]
        assert counters["estimator.solves"] == 1
        assert not {"scan.kernel.regs", "scan.kernel.wide"} & set(counters)
    finally:
        obs.disable()
        obs.reset()
