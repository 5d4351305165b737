"""The readings of the port's ranges in a profiled stretch
(:mod:`portbench.spans` and the per-layer metrics that read them), on
stretches built from plain tuples, and a traced CPU run of the ``small``
mix."""
import types

import numpy as np
import pytest

from portbench import harness, profiling, spans

NEW = ("engine.pack_ms", "solve.host_ms.batch", "solve.host_ms.long",
       "solve.waits.batch", "solve.waits.long", "linearise.device_ms",
       "elements.device_ms", "recover.device_ms", "cost.device_ms")


def ctx(profile):
    return types.SimpleNamespace(
        config={}, window_s=10.0, setup_s=1.0, latencies_s=np.array([]),
        completed=0, spans=[], counters={}, profile=profile, solves=[],
        record_lengths=[], ny=2, itemsize=8)


def read(name, profile):
    return harness.reader(name)(ctx(profile))


# one wave of 200 us: the pack copies to the card, the solve launches three
# kernels and a copy back, waits on the stream once, and the harness
# copies the answer back after the wave's step
CPU = [("portbench.wave", 0.0, 200.0), ("portbench.step", 0.0, 150.0),
       ("engine.step", 5.0, 140.0),
       ("engine.pack", 10.0, 30.0), ("cudaMemcpyAsync", 20.0, 25.0),
       ("estimator.solve", 35.0, 120.0),
       ("solve.elements", 40.0, 60.0), ("cudaLaunchKernel", 45.0, 47.0),
       ("solve.cost", 60.0, 100.0), ("cudaLaunchKernel", 62.0, 64.0),
       ("cudaStreamSynchronize", 65.0, 100.0),
       ("solve.recover", 100.0, 110.0), ("cudaLaunchKernel", 101.0, 102.0),
       ("cudaMemcpyAsync", 106.0, 109.0),
       ("engine.slice", 125.0, 135.0),
       ("portbench.collect", 150.0, 200.0), ("cudaMemcpyAsync", 160.0, 170.0)]
DEV = [("Memcpy HtoD (Pageable -> Device)", 22.0, 26.0),
       ("gemm", 50.0, 70.0), ("gesvdj", 70.0, 100.0), ("k2", 103.0, 105.0),
       ("Memcpy DtoH (Device -> Pageable)", 106.0, 108.0),
       ("Memcpy DtoH (Device -> Pageable)", 161.0, 169.0),
       ("engine.step", 50.0, 108.0)]


def test_device_time_goes_to_the_range_open_at_its_launch():
    s = spans.Stretch(profiling.Profile(CPU, DEV))
    assert [n for _, _, n in s.ranges] == [
        "engine.step", "engine.pack", "estimator.solve", "solve.elements",
        "solve.cost", "solve.recover", "engine.slice"]
    got = s.device_by_span()
    assert got == pytest.approx({
        "solve.cost": 30e-6, "solve.elements": 20e-6, spans.OUTSIDE: 8e-6,
        "engine.pack": 4e-6, "solve.recover": 4e-6})
    assert sum(got.values()) == pytest.approx(s.profile.busy_s)


def test_idle_time_goes_to_the_range_open_when_the_gap_ended():
    s = spans.Stretch(profiling.Profile(CPU, DEV))
    got = s.idle_by_span()
    # gaps 0-22, 26-50, 100-103, 105-106, 108-161 end with operations
    # launched at 20, 45, 101, 106 and 160: their middles on the host's
    # clock are 9, 33, 99.5, 105.5 and 133.5; the last gap, 169-200,
    # ends with the stretch (device clock, 184.5)
    assert got == pytest.approx({
        "engine.slice": 53e-6, "engine.step": 46e-6, spans.OUTSIDE: 31e-6,
        "solve.cost": 3e-6, "solve.recover": 1e-6})
    p = s.profile
    assert sum(got.values()) == pytest.approx(p.window_s - p.busy_s)


def test_a_drifting_device_clock_moves_nothing():
    """The card's clock runs behind the host's by a growing amount (an
    operation recorded before its own call): the pairing and the ranges
    it gives are the same."""
    drift = [(n, a - 0.08 * a, b - 0.08 * a) for n, a, b in DEV]
    s = spans.Stretch(profiling.Profile(CPU, drift))
    base = spans.Stretch(profiling.Profile(CPU, DEV))
    assert [c for c, _ in s.pairs] == [c for c, _ in base.pairs]
    assert s.device_by_span() == pytest.approx(base.device_by_span())
    assert s.waits_by_span() == base.waits_by_span()


def test_waits_are_syncs_and_copies_back_counted_where_they_start():
    s = spans.Stretch(profiling.Profile(CPU, DEV))
    assert [c[1] for c in s.waits] == [65.0, 106.0, 160.0]
    assert s.waits_by_span() == {"solve.cost": [1, pytest.approx(35e-6)],
                                 "solve.recover": [1, pytest.approx(3e-6)],
                                 spans.OUTSIDE: [1, pytest.approx(10e-6)]}
    assert s.waits_in(spans.SOLVE) == (2, pytest.approx(38e-6))
    assert s.waits_in("engine.pack") == (0, 0)


def test_per_solve_readers():
    p = profiling.Profile(CPU, DEV)
    assert read("engine.pack_ms", p) == pytest.approx(0.020)
    # 85 us in the solve, 38 of them waiting
    for cell in ("batch", "long"):
        assert read(f"solve.host_ms.{cell}", p) == pytest.approx(0.047)
        assert read(f"solve.waits.{cell}", p) == 2
    assert read("elements.device_ms", p) == pytest.approx(0.020)
    assert read("cost.device_ms", p) == pytest.approx(0.030)
    assert read("recover.device_ms", p) == pytest.approx(0.004)
    assert read("linearise.device_ms", p) is None      # no such range
    # two waves: every reading is per solve
    later = [(n, a + 200.0, b + 200.0) for n, a, b in CPU]
    p2 = profiling.Profile(CPU + later,
                           DEV + [(n, a + 200.0, b + 200.0)
                                  for n, a, b in DEV])
    for name in NEW:
        assert read(name, p2) == read(name, p)


@pytest.mark.parametrize("lost", [
    [("cudaLaunchKernel", 1.0, 2.0), ("cudaMemcpyAsync", 3.0, 4.0)],
    [("cudaMemsetAsync", 190.0, 191.0), ("cudaLaunchKernel", 195.0, 196.0)],
    [("cudaMemcpyAsync", 3.0, 4.0), ("cudaLaunchKernel", 195.0, 196.0)]],
    ids=["first", "last", "both"])
def test_calls_whose_operations_the_profile_lost_are_set_aside(lost):
    """The profiler loses the device records of its first calls, and the
    device's clock may put the last operations past the stretch: those
    calls are set aside, by the kinds, and the rest pair as before."""
    s = spans.Stretch(profiling.Profile(CPU + lost, DEV))
    base = spans.Stretch(profiling.Profile(CPU, DEV))
    assert s.pairs == base.pairs
    assert s.device_by_span() == base.device_by_span()


@pytest.mark.parametrize("dev", [
    DEV + [("stray", 180.0, 181.0)],
    [DEV[0], ("Memset (Device)", 50.0, 70.0)] + DEV[2:]],
    ids=["more operations than calls", "kinds out of order"])
def test_unpaired_stretch_gives_no_device_reading(dev, capsys):
    """Operations that no cut of the calls explains pair nothing: the
    device readings find nothing, a line on stderr says so, and the host
    readings stay."""
    s = spans.Stretch(profiling.Profile(CPU, dev))
    assert s.pairs is None and s.device_by_span() is None
    assert "device readings by range are left out" in capsys.readouterr().err
    p = s.profile
    for name in ("elements.device_ms", "cost.device_ms", "recover.device_ms"):
        assert read(name, p) is None
    assert read("engine.pack_ms", p) == pytest.approx(0.020)
    assert sum(s.idle_by_span().values()) == pytest.approx(
        p.window_s - p.busy_s)


def test_stretch_without_the_ports_ranges_reads_nothing():
    """A program that opens no range (the parent of this reading) gives
    no value, and no reader raises."""
    cpu = [e for e in CPU if not e[0].startswith(spans.ROOTS)]
    p = profiling.Profile(cpu, DEV)
    for name in NEW:
        assert read(name, p) is None
        assert read(name, None) is None


def test_traced_cpu_run_reports_the_host_readings(small):
    """A traced run of the ``small`` mix on the CPU reports the pack and
    the solve's dispatch from the port's ranges (no device reading: the
    CPU has no device operations)."""
    result = harness.run_cell("wiener-batch64", 11, 2.0, True, device="cpu",
                              traffic_over=small["wiener-batch64"],
                              check_over={"sample": 4}, log=lambda m: None)
    m = result["metrics"]
    assert result["correct"]
    assert m["engine.pack_ms"]["value"] > 0
    assert m["engine.pack_ms"]["unit"] == "ms"
    assert m["solve.host_ms.batch"]["value"] > 0
    assert m["solve.waits.batch"]["value"] == 0
    for name in ("elements.device_ms", "recover.device_ms",
                 "cost.device_ms"):
        assert name not in m
