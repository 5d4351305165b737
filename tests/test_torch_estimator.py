"""The port's slice as a whole: ``repro_torch`` ``Estimator.solve`` held
against the JAX reference's ``Estimator(method="parallel_rts")``.

Both packages solve the same problems (the reference's Wiener velocity and
random time-varying test models; measurements from the reference's own
simulator and seeded numpy draws) on single, stacked, masked and prior-carrying layouts.  The
port runs ``parallel_kernel`` (its CUDA-kernel method, here on the CPU
through the kernel's plain version) and ``parallel_rts``.  Tolerances are
those of ``tests/test_parallel_kernel.py``: ``max|dx| < 1e-8``, ``S``/``v``
rtol 1e-9 atol 1e-8.  Also: the surface's validation, its device rule and
the import boundary (the port never imports JAX or the reference).
"""
import gc
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from helpers import random_ltv, wiener_velocity
from repro.core import clear_cache as jclear_cache
from repro.core import Estimator as JEstimator
from repro.core import ParallelOptions as JParallelOptions
from repro.core import Problem as JProblem
from repro.core import simulate_linear, time_grid
from repro_torch.convert import linear_sde_from_numpy
from repro_torch.core import (
    Estimator,
    KernelOptions,
    ParallelOptions,
    Problem,
    SequentialOptions,
    method_names,
)

torch.set_num_threads(1)

NSUB = 5
N = 20
B = 3
METHODS = {
    "parallel_kernel": KernelOptions(nsub=NSUB, mode="discrete"),
    "parallel_rts": ParallelOptions(nsub=NSUB, mode="discrete"),
}


def _arrays(model, names=("F", "c", "H", "r", "Q", "R", "m0", "P0")):
    return {k: np.asarray(getattr(model, k)) for k in names}


def _psd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T / n + 0.5 * np.eye(n)


def _ltv_pair(key):
    """The reference's random LTV model and the port's, rebuilt from the
    same JAX draws (its F(t), c(t) become torch callables)."""
    jmodel = random_ltv(key)
    ks = jax.random.split(key, 6)
    A = torch.as_tensor(np.array(jax.random.normal(ks[0], (3, 3)) * 0.3))
    Bm = torch.as_tensor(np.array(jax.random.normal(ks[1], (3, 3)) * 0.2))
    cvec = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64)
    arrs = _arrays(jmodel, ("H", "r", "Q", "R", "m0", "P0"))
    arrs["F"] = lambda t: A + Bm * torch.sin(t)
    arrs["c"] = lambda t: cvec * torch.cos(t)
    np.testing.assert_allclose(np.asarray(jmodel.F(0.3)),
                               arrs["F"](torch.tensor(0.3,
                                                      dtype=torch.float64)
                                         ).numpy(),
                               rtol=1e-14)
    return jmodel, linear_sde_from_numpy(arrs)


@pytest.fixture(scope="module")
def cases():
    """(reference model, port model, ts, stacked measurements) per model."""
    out = {}
    jw = wiener_velocity()
    ts = time_grid(0.0, 1.0, N)
    _, y = simulate_linear(jw, ts, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # one simulated record, plus seeded numpy perturbations of it
    ys = np.asarray(y)[None] + 0.1 * rng.standard_normal((B, N, 2))
    out["wiener"] = (jw, linear_sde_from_numpy(_arrays(jw)), np.asarray(ts),
                     ys)
    jl, tl = _ltv_pair(jax.random.PRNGKey(7))
    out["ltv"] = (jl, tl, np.asarray(ts), rng.standard_normal((B, N, 2)))
    return out


def _assert_sol_close(got, ref):
    x, S, v = (np.asarray(getattr(ref, f)) for f in ("x", "S", "v"))
    assert got.x.shape == x.shape and got.x.device.type == "cpu"
    assert float(np.max(np.abs(got.x.numpy() - x))) < 1e-8
    np.testing.assert_allclose(got.S.numpy(), S, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(got.v.numpy(), v, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9, atol=1e-8)


def _layouts(jmodel, tmodel, ts, ys):
    """(name, reference problem, port problem) for every layout."""
    rng = np.random.default_rng(2)
    mask1 = (rng.random(N) > 0.3).astype(np.float64)
    maskb = (rng.random((B, N)) > 0.3).astype(np.float64)
    nx = tmodel.nx
    S0 = _psd(rng, nx)
    v0 = rng.standard_normal(nx)
    S0b = np.stack([_psd(rng, nx) for _ in range(B)])
    v0b = rng.standard_normal((B, nx))
    tsb = np.stack([ts] * B)
    specs = {
        "single": (lambda m, P: P.single(m, ts, ys[0])),
        "stacked": (lambda m, P: P.stacked(m, ts, ys)),
        "stacked_ts": (lambda m, P: P.stacked(m, tsb, ys)),
        "mask": (lambda m, P: P.single(m, ts, ys[1],
                                       measurement_mask=mask1)),
        "stacked_mask": (lambda m, P: P.stacked(m, ts, ys,
                                                measurement_mask=maskb)),
        "prior": (lambda m, P: P.single(m, ts, ys[2], prior=(S0, v0))),
        "stacked_prior": (lambda m, P: P.stacked(m, ts, ys,
                                                 prior=(S0b, v0b))),
    }
    return {k: (f(jmodel, JProblem), f(tmodel, Problem))
            for k, f in specs.items()}


@pytest.mark.parametrize("model_name", ["wiener", "ltv"])
def test_slice_matches_reference(cases, model_name):
    jmodel, tmodel, ts, ys = cases[model_name]
    jest = JEstimator(jmodel, method="parallel_rts",
                      options=JParallelOptions(nsub=NSUB, mode="discrete"))
    ests = {m: Estimator(tmodel, method=m, options=o, device="cpu")
            for m, o in METHODS.items()}
    layouts = _layouts(jmodel, tmodel, ts, ys)
    if model_name == "ltv":          # the time-varying model: two layouts
        layouts = {k: layouts[k] for k in ("single", "stacked_mask")}
    for name, (jp, tp) in layouts.items():
        ref = jest.solve(jp)
        for method, est in ests.items():
            try:
                _assert_sol_close(est.solve(tp), ref)
            except AssertionError as err:
                raise AssertionError(f"{method} on {name}: {err}") from None


def test_parallel_equals_sequential_on_the_port(cases):
    """The discrete-mode exactness claim within the port itself."""
    _, tmodel, ts, ys = cases["wiener"]
    p = Problem.stacked(tmodel, ts, ys)
    par = Estimator(tmodel, method="parallel_kernel",
                    options=METHODS["parallel_kernel"], device="cpu").solve(p)
    seq = Estimator(tmodel, method="sequential_rts",
                    options=SequentialOptions(mode="discrete"),
                    device="cpu").solve(p)
    assert float((par.x - seq.x).abs().max()) < 1e-8
    torch.testing.assert_close(par.S, seq.S, rtol=1e-9, atol=1e-8)


def test_methods_and_options():
    assert set(method_names()) >= {"parallel_rts", "parallel_kernel",
                                   "sequential_rts"}
    for bad in (dict(block_size=100), dict(block_size=512),
                dict(precision="bf16"), dict(mode="bogus"), dict(nsub=0)):
        with pytest.raises(ValueError):
            KernelOptions(**bad)
    with pytest.raises(TypeError):
        KernelOptions(interpret=True)          # no Pallas interpreter here


def test_estimator_device_rule(cases, monkeypatch):
    """No ``device`` means the card; without one that raises, and only an
    explicit ``device="cpu"`` solves on the CPU."""
    _, tmodel, ts, ys = cases["wiener"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Estimator(tmodel, device=device)
    est = Estimator(tmodel, options=METHODS["parallel_rts"], device="cpu")
    assert est.solve(Problem.single(tmodel, ts, ys[0])).x.device.type == \
        "cpu"


def test_estimator_rejects_bad_use(cases):
    _, tmodel, ts, ys = cases["wiener"]
    p = Problem.single(tmodel, ts, ys[0])
    # the default mode (euler) and rk4 solve since the ODE modes were
    # ported; an unknown mode is still refused
    for est in (Estimator(tmodel, device="cpu"),
                Estimator(tmodel, method="parallel_kernel", device="cpu",
                          options=KernelOptions(nsub=NSUB, mode="rk4"))):
        assert bool(torch.isfinite(est.solve(p).x).all())
    with pytest.raises(ValueError, match="mode must be one of"):
        KernelOptions(nsub=NSUB, mode="bogus")
    with pytest.raises(ValueError, match="method must be one of"):
        Estimator(tmodel, method="nope", device="cpu")
    with pytest.raises(TypeError, match="KernelOptions"):
        Estimator(tmodel, method="parallel_kernel", device="cpu",
                  options=ParallelOptions())
    other = linear_sde_from_numpy(_arrays(wiener_velocity()))
    with pytest.raises(ValueError, match="same model instance"):
        Estimator(other, device="cpu",
                  options=METHODS["parallel_rts"]).solve(p)
    with pytest.raises(ValueError, match="not divisible"):
        Estimator(tmodel, device="cpu", options=ParallelOptions(
            nsub=3, mode="discrete")).solve(p)


def test_problem_validation_mirrors_reference(cases):
    """Each malformed problem is rejected by BOTH packages."""
    jmodel, tmodel, ts, ys = cases["wiener"]
    y = ys[0]
    bad = {
        "y must be (N, ny)": lambda P, m: P.single(m, ts, y[None]),
        "ts must be (N+1,)": lambda P, m: P.single(m, ts[:-1], y),
        "measurement dimension": lambda P, m: P.single(m, ts, y[:, :1]),
        "measurement_mask must have shape": lambda P, m: P.single(
            m, ts, y, measurement_mask=np.ones(N - 1)),
        "real 0/1": lambda P, m: P.single(
            m, ts, y, measurement_mask=np.ones(N) * 1j),
        "prior (S0, v0) must have shapes": lambda P, m: P.single(
            m, ts, y, prior=(np.eye(3), np.zeros(3))),
        "information-form pair": lambda P, m: P.single(m, ts, y,
                                                       prior=np.eye(4)),
        "ys must be (B, N, ny)": lambda P, m: P.stacked(m, ts, y),
        "points but ys has": lambda P, m: P.stacked(m, ts[:-1], ys),
        "ts batch": lambda P, m: P.stacked(m, np.stack([ts] * 2), ys),
        "both shared or both per-record": lambda P, m: P.stacked(
            m, ts, ys, prior=(np.stack([np.eye(4)] * B), np.zeros(4))),
    }
    for match, build in bad.items():
        for P, m in ((JProblem, jmodel), (Problem, tmodel)):
            with pytest.raises(ValueError, match=re.escape(match)):
                build(P, m)
    p = Problem.stacked(tmodel, ts, ys,
                        measurement_mask=np.ones((B, N), dtype=bool))
    assert p.measurement_mask.dtype == torch.float64
    assert p.num_records == B


def test_port_imports_neither_jax_nor_reference():
    """Import the port and every submodule in a fresh interpreter; neither
    ``jax`` nor ``repro`` may be loaded."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 59


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
