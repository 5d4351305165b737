"""The PyTorch port's pipeline schedule, compressed data-parallel
all-reduce and launch meshes against the JAX reference.

The port's functions run on single-controller meshes of 8 x ``cpu``; the
reference's run in a subprocess with 8 forced host devices, as
``tests/test_distributed.py`` runs them, on the same seeded inputs passed
through an ``npz`` file.  Tolerances: the pipeline 1e-9 at float64 (the
reference's own); the compressed mean holds exactly the reference's bf16
roundings (the per-shard errors are bit-identical) and its sum to 1e-6
relative, since the sums run in another order; error feedback meets the
reference's 0.05 / 2e-3 bounds.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.distributed import (
    Mesh,
    compressed_psum,
    init_error_state,
    make_compressed_dp_step,
    pipeline_forward,
)
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, D, M = 8, 16, 4              # stages, width, microbatches
SHARDS, STEPS, LR = 8, 3, 0.05  # data-parallel shards, steps, SGD rate

_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
"""

_RUN = """
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.grad_compress import (
    compressed_psum, init_error_state, make_compressed_dp_step)
from repro.distributed.pipeline import pipeline_forward
from repro.launch.mesh import make_host_mesh

inp = dict(np.load(sys.argv[1]))
out = {}

mesh = jax.make_mesh((8,), ("pipe",))
out["pipe"] = np.asarray(pipeline_forward(
    lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["Ws"]),
    jnp.asarray(inp["xs"]), mesh, axis_name="pipe"))

def shards(a):
    return np.stack([np.asarray(s.data).reshape(a.shape)
                     for s in sorted(a.addressable_shards,
                                     key=lambda s: s.device.id)])

mesh = jax.make_mesh((8,), ("data",))
g = {"w": jnp.asarray(inp["g"], jnp.float32)}
f = shard_map(partial(compressed_psum, axis_name="data"),
              mesh=mesh, in_specs=({"w": P("data")}, {"w": P()}),
              out_specs=({"w": P()}, {"w": P()}), check_rep=False)
err = init_error_state({"w": g["w"][0]})
mean, err = f(g, err)
out["mean1"], out["err1"] = np.asarray(mean["w"][0]), shards(err["w"])[:, 0]
tot = mean["w"][0]
for _ in range(int(inp["steps"]) - 1):
    mean, err = f(g, err)
    tot = tot + mean["w"][0]
out["tot"], out["errN"] = np.asarray(tot), shards(err["w"])[:, 0]

def loss_fn(p, batch):
    r = batch["x"] @ p["w"] + p["b"] - batch["y"]
    return jnp.mean(r * r)

def sgd(grads, opt, params):
    new = jax.tree_util.tree_map(lambda p, g: p - float(inp["lr"]) * g,
                                 params, grads)
    return new, opt + 1

step = jax.jit(make_compressed_dp_step(loss_fn, sgd, mesh, "data"))
params = {"w": jnp.asarray(inp["w0"]), "b": jnp.asarray(inp["b0"])}
err = init_error_state(params)
opt = jnp.zeros((), jnp.int32)
batch = {"x": jnp.asarray(inp["x"]), "y": jnp.asarray(inp["y"])}
for i in range(int(inp["dp_steps"])):
    params, opt, err, loss = step(params, opt, err, batch)
    out[f"dp_loss{i}"] = np.asarray(loss)
    out[f"dp_w{i}"], out[f"dp_b{i}"] = (np.asarray(params["w"]),
                                        np.asarray(params["b"]))
    out[f"dp_err_w{i}"] = shards(err["w"])
out["dp_opt"] = np.asarray(opt)

out["host_shape"] = np.asarray(make_host_mesh(2).devices.shape)
try:
    make_host_mesh(3)
except AssertionError:
    out["host_3_raises"] = np.asarray(True)
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""

_MESHES = """
from repro.launch.mesh import make_production_mesh
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    print(multi, tuple(m.axis_names), tuple(m.devices.shape))
"""


def _reference(script: str, devices: int, *args, timeout=600) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c",
         _REFERENCE.format(devices=devices) + textwrap.dedent(script),
         *args], capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return out.stdout


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The seeded inputs, and the reference's outputs on them."""
    rng = np.random.default_rng(0)
    inp = dict(
        Ws=rng.standard_normal((S, D, D)) / np.sqrt(D),
        xs=rng.standard_normal((M, 3, D)),
        g=rng.standard_normal((SHARDS, 64)).astype(np.float32),
        steps=np.asarray(40),
        w0=rng.standard_normal(D), b0=np.asarray(0.5),
        x=rng.standard_normal((2 * SHARDS, D)),
        y=rng.standard_normal(2 * SHARDS),
        lr=np.asarray(LR), dp_steps=np.asarray(STEPS))
    d = tmp_path_factory.mktemp("pipeline")
    np.savez(d / "in.npz", **inp)
    out = _reference(_RUN, 8, str(d / "in.npz"), str(d / "out.npz"))
    assert "REFERENCE-OK" in out
    return inp, dict(np.load(d / "out.npz"))


def cpu_mesh(n: int, axis: str) -> Mesh:
    return Mesh(["cpu"] * n, (axis,))


def _stage(w, x):
    return torch.tanh(x @ w)


def test_pipeline_forward_matches_reference(run):
    inp, ref = run
    Ws, xs = torch.as_tensor(inp["Ws"]), torch.as_tensor(inp["xs"])
    got = pipeline_forward(_stage, Ws, xs, cpu_mesh(S, "pipe"))
    np.testing.assert_allclose(got.numpy(), ref["pipe"], rtol=1e-9,
                               atol=1e-9)
    seq = []
    for x in xs:                     # unpipelined, microbatch by microbatch
        for i in range(S):
            x = torch.tanh(x @ Ws[i])
        seq.append(x)
    assert torch.equal(got, torch.stack(seq))


@pytest.mark.parametrize("stages,micro", [(4, 10), (3, 1), (1, 2)])
def test_pipeline_schedule_runs_each_pair_once(stages, micro):
    """Every (stage, microbatch) pair runs once, at tick ``mb + stage``,
    on its stage's device; the outputs come back in microbatch order."""
    g = torch.Generator().manual_seed(stages * 100 + micro)
    Ws = {"w": torch.randn(stages, D, D, generator=g, dtype=torch.float64),
          "s": torch.arange(stages, dtype=torch.float64)}
    xs = torch.randn(micro, 2, D, generator=g, dtype=torch.float64)
    calls = []

    def stage(p, x):
        calls.append((int(p["s"]), x.device.type))
        return torch.tanh(x @ p["w"]) + p["s"]

    got = pipeline_forward(stage, Ws, xs, cpu_mesh(stages, "pipe"),
                           axis_name="pipe")
    want = []
    for m in range(micro):
        x = xs[m]
        for s in range(stages):
            x = torch.tanh(x @ Ws["w"][s]) + s
        want.append(x)
    assert torch.equal(got, torch.stack(want))
    assert sorted(calls) == sorted((s, "cpu") for s in range(stages)
                                   for _ in range(micro))
    with pytest.raises(ValueError, match="leading stage axis"):
        pipeline_forward(stage, Ws, xs, cpu_mesh(stages + 1, "pipe"))


def _per_shard(g, n):
    return [{"w": torch.as_tensor(g[j])} for j in range(n)]


def test_compressed_psum_matches_reference(run):
    inp, ref = run
    mesh = cpu_mesh(SHARDS, "data")
    grads = _per_shard(inp["g"], SHARDS)
    err = [init_error_state(g) for g in grads]
    assert all(e["w"].dtype == torch.float32 and not e["w"].any()
               for e in err)
    means, err = compressed_psum(grads, err, mesh, "data")
    for m in means:                              # the mean on every shard
        assert torch.equal(m["w"], means[0]["w"])
    np.testing.assert_array_equal(np.stack([e["w"].numpy() for e in err]),
                                  ref["err1"])
    np.testing.assert_allclose(means[0]["w"].numpy(), ref["mean1"],
                               rtol=1e-6, atol=0)
    exact = inp["g"].mean(axis=0)
    q_err = np.abs(means[0]["w"].numpy() - exact).max()
    assert q_err < 0.05, q_err
    with pytest.raises(ValueError, match="one gradient and one error"):
        compressed_psum(grads[:3], err, mesh, "data")


def test_error_feedback_matches_reference(run):
    """40 compressions of a constant gradient: the residual is re-injected,
    so the running mean converges on the exact mean (the reference's
    bound), and every shard's error is the reference's, bit for bit."""
    inp, ref = run
    mesh = cpu_mesh(SHARDS, "data")
    grads = _per_shard(inp["g"], SHARDS)
    err = [init_error_state(g) for g in grads]
    steps = int(inp["steps"])
    tot = torch.zeros(64)
    for _ in range(steps):
        means, err = compressed_psum(grads, err, mesh, "data")
        tot = tot + means[0]["w"]
    np.testing.assert_array_equal(np.stack([e["w"].numpy() for e in err]),
                                  ref["errN"])
    np.testing.assert_allclose(tot.numpy(), ref["tot"], rtol=1e-6,
                               atol=1e-6)
    exact = inp["g"].mean(axis=0)
    drift = np.abs(tot.numpy() / steps - exact).max()
    assert drift < 2e-3, drift
    assert np.abs(ref["tot"] / steps - exact).max() < 2e-3


def test_compressed_dp_step_matches_reference(run):
    """Three data-parallel SGD steps of a float64 least-squares model over
    8 shards: losses and params to 1e-6 relative (the means' sums run in
    another order), the first step's per-shard errors bit for bit."""
    inp, ref = run
    mesh = cpu_mesh(SHARDS, "data")

    def loss_fn(p, batch):
        r = batch["x"] @ p["w"] + p["b"] - batch["y"]
        return torch.mean(r * r)

    def sgd(grads, opt, params):
        return tree.tree_map(lambda p, g: p - LR * g, params, grads), opt + 1

    step = make_compressed_dp_step(loss_fn, sgd, mesh, "data")
    params = {"w": torch.as_tensor(inp["w0"]),
              "b": torch.as_tensor(inp["b0"])}
    err = [init_error_state(params) for _ in range(SHARDS)]
    opt = 0
    batch = {"x": torch.as_tensor(inp["x"]), "y": torch.as_tensor(inp["y"])}
    for i in range(STEPS):
        params, opt, err, loss = step(params, opt, err, batch)
        np.testing.assert_allclose(loss.numpy(), ref[f"dp_loss{i}"],
                                   rtol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(params[k].numpy(), ref[f"dp_{k}{i}"],
                                       rtol=1e-6, atol=1e-8)
        assert params["w"].dtype == torch.float64
        if i == 0:
            np.testing.assert_array_equal(
                np.stack([e["w"].numpy() for e in err]), ref["dp_err_w0"])
    assert opt == int(ref["dp_opt"]) == STEPS
    with pytest.raises(ValueError, match="do not split"):
        step(params, opt, err, {"x": batch["x"][:5], "y": batch["y"][:5]})


def test_host_mesh_matches_reference(run, monkeypatch):
    """``make_host_mesh(model)``: ``(n // model, model)`` over ``("data",
    "model")`` on the distinct visible devices, the reference's shape on 8
    devices, and its assertion when ``model`` does not divide them."""
    _, ref = run
    one = tmesh.make_host_mesh(device_type="cpu")
    assert one.axis_names == ("data", "model")
    assert one.devices.shape == (1, 1)
    monkeypatch.setattr(tmesh, "default_devices",
                        lambda device_type: [torch.device(device_type)] * 8)
    m = tmesh.make_host_mesh(2, device_type="cpu")
    assert m.devices.shape == tuple(ref["host_shape"]) == (4, 2)
    assert bool(ref["host_3_raises"])
    with pytest.raises(AssertionError):
        tmesh.make_host_mesh(3, device_type="cpu")


def test_production_mesh_matches_reference():
    """The reference's layouts on 256 / 512 devices (a device list that
    repeats ``cpu`` here); without a list and without that many cards the
    port raises instead of shrinking the layout."""
    lines = _reference(_MESHES, 512).strip().splitlines()[-2:]
    want = {}
    for line in lines:
        multi, rest = line.split(" ", 1)
        want[multi == "True"] = rest
    for multi, n in ((False, 256), (True, 512)):
        m = tmesh.make_production_mesh(multi_pod=multi,
                                       devices=["cpu"] * n)
        assert f"{m.axis_names} {m.devices.shape}" == want[multi]
        assert all(d == torch.device("cpu") for d in m.devices.flat)
        with pytest.raises(ValueError, match=f"needs {n}"):
            tmesh.make_production_mesh(multi_pod=multi)
        with pytest.raises(ValueError, match=f"needs {n} devices, got 8"):
            tmesh.make_production_mesh(multi_pod=multi,
                                       devices=["cpu"] * 8)
