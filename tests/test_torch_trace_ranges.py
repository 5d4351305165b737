"""The port's ranges on the ``torch.profiler`` timeline: a Wiener wave of
``TrajectoryEngine(method="parallel_kernel")`` and a coordinated-turn
iterated solve on the CPU, under a profiler, open the ranges of each layer
of the wave and the solve (``repro_torch.obs.tracing``), nested and in
order, with telemetry on and off; their outputs are bit-identical to
those of the same solves without a profiler."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import coordinated_turn, wiener_velocity
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    Problem,
    simulate_linear,
    simulate_nonlinear,
    time_grid,
)
from repro_torch.serving import TrajectoryEngine

# torch's forward-mode AD (the Taylor linearisation) loads its
# decompositions through ``torch.jit.script``, which torch marks deprecated
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

NSUB, N, ROWS = 5, 40, 3
PASS = ["solve.elements", "solve.scan", "solve.fill", "solve.recover",
        "solve.cost"]
WIENER_SOLVE = ["solve.grid"] + PASS
MEASURED = {"estimator.solve.prepare", "estimator.solve.compile",
            "estimator.solve.execute", "estimator.solve.host_transfer"}


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def ranges(prof) -> list:
    """The port's ranges as ``[name, [children...]]`` trees, in order, by
    the containment of their host intervals."""
    events = sorted(
        ((e.time_range.start, -e.time_range.end, e.name)
         for e in prof.events()
         if e.name.split(".")[0] in ("engine", "estimator", "solve")),
        key=lambda t: (t[0], t[1]))
    roots, stack = [], []
    for a, neg_b, name in events:
        while stack and a >= stack[-1][0]:
            stack.pop()
        node = [name, []]
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((-neg_b, node))
    return roots


def names(nodes) -> list:
    return [n for n, _ in nodes]


def solve_children(solve, measured: bool) -> list:
    """The ``solve.*`` ranges under one ``estimator.solve`` range; on the
    measured path they sit under its ``execute``/``compile`` phase."""
    if not measured:
        return solve[1]
    assert set(names(solve[1])) <= MEASURED
    (phase,) = [c for c in solve[1] if c[0] in (
        "estimator.solve.compile", "estimator.solve.execute")]
    return phase[1]


def wiener_engine():
    model = wiener_velocity.config().model(device="cpu")
    ts = time_grid(0.0, 1.0, N)
    _, y = simulate_linear(model, ts[:, None].expand(-1, ROWS),
                           torch.Generator().manual_seed(0))
    eng = TrajectoryEngine(model, batch=ROWS, method="parallel_kernel",
                           options=KernelOptions(nsub=NSUB, mode="discrete"),
                           device="cpu")
    return eng, [(ts.numpy(), y[:, r].numpy()) for r in range(ROWS)]


def wave(eng, records) -> list:
    tickets = [eng.submit(ts, y) for ts, y in records]
    eng.step()
    got = dict(eng.collect(tickets=tickets))
    return [got[t] for t in tickets]


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_wiener_wave_ranges_nest_in_order(telemetry):
    eng, records = wiener_engine()
    plain = wave(eng, records)                 # also warms the entry
    if telemetry:
        obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = wave(eng, records)
    (step,) = ranges(prof)
    assert step[0] == "engine.step"
    assert names(step[1]) == ["engine.pack", "estimator.solve",
                              "engine.slice"]
    solve = step[1][1]
    inner = solve_children(solve, telemetry)
    assert names(inner) == WIENER_SOLVE
    assert all(not c[1] for c in inner)
    for a, b in zip(plain, traced):
        for f in ("x", "S", "v", "cost"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_ct_iterated_solve_ranges_nest_in_order(telemetry):
    cfg = coordinated_turn.config()
    model = cfg.model(device="cpu")
    ts = time_grid(0.0, 0.25, N // 2)
    _, y = simulate_nonlinear(model, ts[:, None].expand(-1, 2),
                              torch.Generator().manual_seed(1))
    est = Estimator(model, method="parallel_kernel", device="cpu",
                    options=IteratedOptions(
                        inner=KernelOptions(nsub=NSUB, mode="discrete"),
                        iterations=cfg.iterations))
    problem = Problem.stacked(model, ts.expand(2, -1), y.movedim(1, 0))
    plain = est.solve(problem)
    if telemetry:
        obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = est.solve(problem)
    (solve,) = ranges(prof)
    assert solve[0] == "estimator.solve"
    inner = solve_children(solve, telemetry)
    assert names(inner) == (["solve.linearise"] + PASS) * cfg.iterations + [
        "solve.cost"]
    assert names(inner).count("solve.linearise") == 5
    for f in ("x", "S", "v", "cost", "cost_trace", "step_norms"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_no_range_and_no_name_change_without_a_profiler():
    """Without a profiler the ranges leave nothing behind, and with
    telemetry on the recorded names are those of the spans alone."""
    eng, records = wiener_engine()
    obs.enable()
    wave(eng, records)
    wave(eng, records)
    snap = obs.snapshot()
    spans = {k for k in snap["histograms"] if k.startswith("span.")}
    assert spans == {"span.engine.step", "span.estimator.solve",
                     "span.estimator.solve.prepare",
                     "span.estimator.solve.compile",
                     "span.estimator.solve.execute",
                     "span.estimator.solve.host_transfer"}
    assert not any(k.startswith(("solve.", "span.solve", "engine.pack",
                                 "engine.slice"))
                   for sec in ("counters", "gauges", "histograms")
                   for k in snap[sec])
