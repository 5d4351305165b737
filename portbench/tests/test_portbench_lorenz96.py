"""The ``lorenz96`` configuration and the ``l96-batch64`` cell on the CPU:
the plain reference against the port at a tiny size, the configuration
file against ``repro_torch.configs.lorenz96``, the benchmark's copy of the
reference against the tier-1 tests' copy, the readers of the cell's two
new metrics, and a traced run of its ``small`` mix."""
import dataclasses
import importlib.util
import types

import numpy as np
import pytest
import torch

from portbench import counts, harness, peaks, profiling, program

pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

CELL, CONFIG = "l96-batch64", "lorenz96"


def cfg_of():
    return harness.load_json(harness.ROOT / "configs" / f"{CONFIG}.json")


def plain_copy():
    path = harness.REPO / "tests" / "plain_lorenz96.py"
    spec = importlib.util.spec_from_file_location("plain_lorenz96_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gap(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def test_reference_matches_port():
    cfg, ref = cfg_of(), harness.reference(CONFIG)
    n = 60
    y = ref.simulate(cfg, [n] * 2, torch.Generator().manual_seed(5))
    want = ref.solve(cfg, y, [n] * 2)
    from repro_torch.core import Estimator, Problem

    model = program.build_model(cfg, "float64", "cpu")
    est = Estimator(model, method=cfg["method"],
                    options=program.solver_options(cfg), device="cpu")
    ts = torch.tensor(cfg["t0"] + cfg["dt"] * np.arange(n + 1))
    got = est.solve(Problem.stacked(model, ts, torch.tensor(y))).x.numpy()
    assert want.shape == got.shape == (2, n + 1, 40)
    assert gap(got, want) < 1e-12
    with pytest.raises(ValueError, match="one length"):
        ref.solve(cfg, y, [n, n - 1])


def test_config_file_holds_the_ports_configuration():
    from repro_torch.configs import lorenz96

    port = lorenz96.config()
    base = port.model()
    cfg = cfg_of()
    built = program.build_model(cfg, "float64", "cpu")
    for f in dataclasses.fields(base):
        a, b = getattr(base, f.name), getattr(built, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
            assert torch.equal(a, torch.tensor(cfg[f.name],
                                                 dtype=torch.float64)), f.name
    assert (cfg["N"], cfg["forcing"], cfg["iterations"]) == (
        port.n, port.forcing, port.iterations)
    assert cfg["options"]["nsub"] == port.nsub
    assert cfg["dt"] == (port.tf - port.t0) / (512 * port.nsub)
    assert cfg["reduced"] == [] and cfg["model"] == "nonlinear"


def test_the_two_copies_of_the_reference_agree():
    cfg, ref, copy = cfg_of(), harness.reference(CONFIG), plain_copy()
    y = ref.simulate(cfg, [40] * 3, torch.Generator().manual_seed(9))
    m = {k: torch.tensor(cfg[k], dtype=torch.float64)
         for k in ("Q", "R", "m0", "P0")}
    args = (torch.tensor(y), m["m0"], m["P0"], m["Q"], m["R"], cfg["dt"],
            cfg["forcing"], cfg["iterations"])
    assert torch.equal(ref.iterated_smoother(*args),
                       copy.iterated_smoother(*args))
    x = torch.tensor(y[0, :, :]).repeat(1, 2)
    assert torch.equal(ref.f_jacobian(x), copy.f_jacobian(x))
    assert torch.equal(ref.f(x, 8.0), copy.f(x, 8.0))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    want = ref.simulate(cfg, [30] * 2, g1)
    got = copy.simulate(m["m0"], m["P0"], m["Q"], m["R"], cfg["dt"],
                        cfg["forcing"], 2, 30, g2)
    np.testing.assert_array_equal(got.numpy(), want)


def stretch(wide_us=(0.0, 0.0)):
    """One wave whose solve opens ``solve.scan`` around two launches of
    the wide kernel of ``wide_us`` microseconds each."""
    cpu = [("portbench.wave", 0.0, 100.0), ("engine.step", 1.0, 90.0),
           ("estimator.solve", 2.0, 80.0),
           ("solve.elements", 3.0, 10.0), ("cudaLaunchKernel", 4.0, 5.0),
           ("solve.scan", 10.0, 20.0), ("cudaLaunchKernel", 11.0, 12.0),
           ("cudaLaunchKernel", 13.0, 14.0),
           ("solve.fill", 20.0, 30.0), ("cudaLaunchKernel", 21.0, 22.0)]
    a, b = wide_us
    dev = [("gemm", 10.0, 20.0),
           ("void lqt_scan_wide_kernel<double>(WideArgs<double>)", 20.0,
            20.0 + a),
           ("void lqt_scan_wide_kernel<double>(WideArgs<double>)", 40.0,
            40.0 + b),
           ("gemm", 70.0, 75.0)]
    return profiling.Profile(cpu, dev)


def ctx(profile, solves=((64, 5120, 20),)):
    return types.SimpleNamespace(
        config=cfg_of(), window_s=10.0, setup_s=1.0,
        latencies_s=np.array([]), completed=0, spans=[], counters={},
        profile=profile, solves=list(solves), record_lengths=[], ny=20,
        itemsize=8)


def test_scan_readers_on_a_stretch():
    p = stretch((15.0, 25.0))
    assert harness.reader("scan.device_ms")(ctx(p)) == pytest.approx(0.040)
    elems = 513
    bound = 5 * max(counts.scan_bytes(elems, 64, 40, 8) / peaks.HBM_BYTES_PER_S,
                    counts.scan_combines(elems) * 64 * counts.combine_flops(40)
                    / peaks.FP64_FLOPS)
    assert harness.reader("lqt_scan_roofline.wide")(ctx(p)) == pytest.approx(
        100.0 * bound / 40e-6)
    assert counts.scan_combines(elems) == 1014
    # the parent: no solve.scan range, no wide kernel
    cpu = [e for e in p._cpu + [("portbench.wave", 0.0, 100.0)]
           if e[0] != "solve.scan"]
    parent = profiling.Profile(cpu, [("gemm", 10.0, 20.0)])
    for name in ("scan.device_ms", "lqt_scan_roofline.wide"):
        assert harness.reader(name)(ctx(parent)) is None
        assert harness.reader(name)(ctx(None)) is None


def test_traced_cpu_run_of_the_small_mix(small):
    """The cell's ``small`` mix, traced, on the CPU: correct, with the
    host readings of the port's ranges; the CPU has no device operations,
    so the device readings (``scan.device_ms`` among them) read nothing
    and raise nothing."""
    result = harness.run_cell(CELL, 2 ** 31 + 96, 2.0, True, device="cpu",
                              traffic_over=small[CELL],
                              check_over={"sample": 4}, log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["checks"]["x_gap"]["value"] < 1e-12
    m = result["metrics"]
    assert set(m) <= {x["name"] for x in harness.cell_metrics(
        harness.benchmark(), "per_layer", CELL)}
    for name in ("scan.device_ms", "lqt_scan_roofline.wide",
                 "elements.device_ms"):
        assert name not in m
