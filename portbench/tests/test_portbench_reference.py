"""The plain reference against the port (``repro_torch``) at tiny sizes on
the CPU: both configurations, ragged lengths through the engine's
pad-and-bucket, and the float32 control failing the comparison."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness, program, traffic

LIMIT = 1e-8          # the cells' limit on x_gap

# torch's forward-mode AD (``torch.func.jacfwd``, the port's Taylor
# linearisation) loads its decompositions through ``torch.jit.script`` on
# first use, which this torch build marks deprecated: not the port's.
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")


def cfg_of(name):
    return harness.load_json(harness.ROOT / "configs" / f"{name}.json")


def gap(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def port_stacked(cfg, y, dtype="float64"):
    from repro_torch.core import Estimator, Problem

    model = program.build_model(cfg, dtype, "cpu")
    est = Estimator(model, method=cfg["method"],
                    options=program.solver_options(cfg), device="cpu")
    n = y.shape[1]
    ts = torch.tensor(cfg["t0"] + cfg["dt"] * np.arange(n + 1))
    return est.solve(Problem.stacked(model, ts, torch.tensor(y))).x.double(
        ).numpy()


def simulate(name, lengths, seed=7):
    ref = harness.reference(name)
    y = ref.simulate(cfg_of(name), lengths, torch.Generator().manual_seed(seed))
    return ref, y


@pytest.mark.parametrize("name,n", [("wiener-velocity", 200),
                                    ("coordinated-turn", 120)])
def test_reference_matches_port(name, n):
    ref, y = simulate(name, [n] * 3)
    want = ref.solve(cfg_of(name), y, [n] * 3)
    got = port_stacked(cfg_of(name), y)
    assert want.shape == got.shape == (3, n + 1, len(cfg_of(name)["m0"]))
    assert gap(got, want) < 1e-12


@pytest.mark.parametrize("name,n", [("wiener-velocity", 200),
                                    ("coordinated-turn", 120)])
def test_float32_control_fails(name, n):
    """The program's own float32 path reads far above the limit."""
    ref, y = simulate(name, [n] * 3)
    want = ref.solve(cfg_of(name), y, [n] * 3)
    got = port_stacked(cfg_of(name), y, dtype="float32")
    assert not np.all(np.isfinite(got)) or gap(got, want) > 10 * LIMIT


def test_ragged_through_engine_matches_unpadded_reference():
    """Records of unequal lengths, padded to power-of-two blocks by the
    engine, against the reference on each record's own grid."""
    cfg = cfg_of("wiener-velocity")
    lengths = np.array([37, 160, 95, 203, 14, 160])
    ref, y = simulate("wiener-velocity", lengths)
    ts = cfg["t0"] + cfg["dt"] * np.arange(lengths.max() + 1)
    engine = program.build_engine(cfg, 4, "float64", "cpu")
    tickets = [engine.submit(ts[:n + 1], y[i, :n])
               for i, n in enumerate(lengths)]
    engine.run()
    got = dict(engine.collect())
    want = ref.solve(cfg, y, lengths)
    for i, (t, n) in enumerate(zip(tickets, lengths)):
        assert gap(got[t].x.numpy(), want[i, :n + 1]) < 1e-12


def test_reference_ignores_measurements_past_a_record():
    """A record's answer depends on its own rows only."""
    ref, y = simulate("wiener-velocity", [50, 50])
    cfg = cfg_of("wiener-velocity")
    a = ref.solve(cfg, y, [30, 50])
    y2 = y.copy()
    y2[0, 30:] = 1e3
    b = ref.solve(cfg, y2, [30, 50])
    np.testing.assert_array_equal(a[0, :31], b[0, :31])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("name,module", [
    ("wiener-velocity", "wiener_velocity"),
    ("coordinated-turn", "coordinated_turn")])
def test_config_files_hold_the_ports_configuration(name, module):
    """Every matrix in the file is the port's configuration's, so the
    benchmark runs the paper's model as the port states it."""
    import importlib

    base = importlib.import_module(f"repro_torch.configs.{module}").config(
        ).model()
    cfg = cfg_of(name)
    built = program.build_model(cfg, "float64", "cpu")
    for f in dataclasses.fields(base):
        a, b = getattr(base, f.name), getattr(built, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert cfg["options"]["nsub"] == importlib.import_module(
        f"repro_torch.configs.{module}").config().nsub


def test_same_lengths_for_every_seed():
    mix = harness.load_json(harness.ROOT / "traffic"
                            / "ragged64-2560-20480.json")
    a = traffic.pool_lengths(mix, 1)
    b = traffic.pool_lengths(mix, 2 ** 31 + 5)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() > 2560 and a.max() <= 20480


def test_same_arrival_gaps_for_every_seed():
    """The open loop's gaps are the exponential law's quantiles at the
    mix's rate over the window, in an order drawn from the seed."""
    mix = harness.load_json(harness.ROOT / "traffic"
                            / "poisson180-2048blocks.json")
    rate = mix["arrivals"]["rate"]
    a = traffic.clients(None, [], mix, 1, 1, 30.0).due
    b = traffic.clients(None, [], mix, 1, 2 ** 31 + 5, 30.0).due
    assert len(a) == len(b) == round(rate * 30.0)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)),
                               np.sort(np.diff(b, prepend=0.0)))
    assert not np.array_equal(a, b)
    assert a[-1] == pytest.approx(30.0, rel=0.05)
