"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped), with the timed path broken underneath: ``correct``
comes out false for each fault that the cell can have, and true without
one.

The faults, planted in the program where it produces its answers:

* ``state_unchanged`` -- the solve returns its starting state, the prior
  mean at every point;
* ``half_batch`` -- half of each wave's rows are left out of the solve and
  take the answers of the rows solved (cells with waves of more than one
  row);
* ``altered_answer`` -- each record's trajectory is altered by a millionth
  of its largest value at one point as the engine slices it out.

The exchange between chips does not exist in these one-chip cells.
"""
import dataclasses

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def state_unchanged(monkeypatch):
    from repro_torch.core.estimator import Estimator

    solve = Estimator.solve

    def broken(self, problem):
        sol = solve(self, problem)
        return dataclasses.replace(
            sol, x=self._model.m0.expand_as(sol.x).clone())

    monkeypatch.setattr(Estimator, "solve", broken)


def half_batch(monkeypatch):
    from repro_torch.core.estimator import Estimator

    solve = Estimator.solve

    def broken(self, problem):
        B = problem.y.shape[0]
        h = B // 2
        mask = problem.measurement_mask
        part = dataclasses.replace(
            problem, ts=problem.ts[:h], y=problem.y[:h],
            measurement_mask=None if mask is None else mask[:h])
        sol = solve(self, part)
        rows = {f: torch.cat([a, a[:B - h]]) for f in
                ("x", "S", "v", "cov", "cost", "cost_trace", "step_norms")
                if (a := getattr(sol, f)) is not None}
        return dataclasses.replace(sol, **rows)

    monkeypatch.setattr(Estimator, "solve", broken)


def altered_answer(monkeypatch):
    from repro_torch.serving import trajectory

    slice_solution = trajectory.slice_solution

    def broken(sol, row, N):
        out = slice_solution(sol, row, N)
        x = out.x.clone()
        x[N // 2, 0] += 1e-6 * x.abs().max()
        return dataclasses.replace(out, x=x)

    monkeypatch.setattr(trajectory, "slice_solution", broken)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}


def run(cell, small):
    return harness.run_cell(cell, 2 ** 31 + 11, 1.0, False, device="cpu",
                            traffic_over=small[cell],
                            check_over={"sample": 4}, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    result = run(cell, small)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, small, monkeypatch):
    if fault == "half_batch" and small[cell]["wave"] < 2:
        pytest.skip("a wave of one row has no half to leave out")
    FAULTS[fault](monkeypatch)
    result = run(cell, small)
    assert not result["correct"], result["checks"]


def test_traced_run_counts_the_stretch_alone(small, monkeypatch):
    """The solves counted for the roofline reader are those of the
    profiled stretch's waves, one per wave, and the records counted for
    the mfu reader those the stretch's waves completed; the stretch runs
    with telemetry off, as the untraced runs do, and leaves no span."""
    import torch
    from repro_torch import obs
    from repro_torch.serving import TrajectoryEngine

    seen, profiled = [], []
    profile = harness.Tracer.profile
    step = TrajectoryEngine.step

    def keep(self):
        seen.append(self)
        return profile(self)

    def watched(self, *a, **kw):
        if torch.autograd._profiler_enabled():
            profiled.append(obs.enabled())
        return step(self, *a, **kw)

    monkeypatch.setattr(harness.Tracer, "profile", keep)
    monkeypatch.setattr(TrajectoryEngine, "step", watched)
    mix = small["wiener-batch64"]
    result = harness.run_cell("wiener-batch64", 5, 2.0, True, device="cpu",
                              traffic_over=mix,
                              check_over={"sample": 4}, log=lambda m: None)
    tracer = seen[0]
    marks = [e for e in tracer.prof.events() if e.name == "portbench.wave"]
    assert len(tracer.solves) == len(marks) > 0
    assert len(tracer.records) == mix["wave"] * len(marks)
    assert profiled == [False] * len(marks)
    assert tracer.spans and result["correct"]
    assert "solve_mfu.batch" in result["metrics"]


def test_lost_answer_is_a_failure(small, monkeypatch):
    """A record whose answer never comes counts as failed, and the run
    ends rather than waiting for it."""
    from repro_torch.serving import TrajectoryEngine

    collect = TrajectoryEngine.collect

    def drops_one(self, tickets=None):
        return [(t, s) for t, s in collect(self, tickets) if t != 10]

    monkeypatch.setattr(TrajectoryEngine, "collect", drops_one)
    result = run("wiener-batch64", small)
    assert result["failed"] == 1 and not result["correct"]
