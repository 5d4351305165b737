"""Tensor lifetimes: nothing of the port's is left to Python's cyclic
garbage collector.

A nested function that calls itself holds itself through its own closure
cell, so every call leaves a reference cycle that keeps whatever the
closure reaches alive until the collector runs; the collector runs on
object counts, not bytes, so on a card such a cycle pins gigabytes.
Here, with ``gc`` disabled: a leaf dies as soon as the last reference to
a tree (and to the tree helpers' results) goes; no nested function in
``src/repro_torch/`` refers to its own name; and each main path (solves,
engine waves, training steps on one device and on a 2 x 2 cpu mesh,
serving, a sharded checkpoint) leaves no tensor in ``gc.garbage`` under
``gc.DEBUG_SAVEALL``.  The tree order stays the reference's
(``jax.tree_util``): sorted dict keys, NamedTuple fields, ``None`` an
empty subtree.
"""
import ast
import contextlib
import dataclasses
import gc
import weakref
from pathlib import Path
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch import tree
from repro_torch.configs.wiener_velocity import WienerVelocityConfig
from repro_torch.core import (
    Estimator,
    ExecutableCache,
    KernelOptions,
    ParallelOptions,
    Problem,
)
from repro_torch.core.sde import simulate_linear, time_grid
from repro_torch.distributed import Mesh, mesh_context, spmd
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.serving import (
    Request,
    ServeEngine,
    StreamingEngine,
    TrajectoryEngine,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import make_shardings, make_train_step

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ARCH = "hymba-1.5b-smoke"
NSUB = 5


@contextlib.contextmanager
def _no_collector():
    """``gc`` disabled, and restored as it was on exit."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class Pair(NamedTuple):
    b: object
    a: object


def _tree():
    """A nested tree: unsorted dict keys, a NamedTuple, a list, a tuple
    and ``None`` subtrees; its leaves are distinct tensors."""
    leaf = iter([torch.tensor([float(i)]) for i in range(6)])
    return {"z": [next(leaf), None, (next(leaf),)],
            "a": Pair(b=next(leaf), a={"y": next(leaf), "x": None}),
            "m": {"k": next(leaf), "c": [next(leaf)]}}


# -- the tree helpers hold nothing ---------------------------------------


def test_leaves_hold_no_leaf_after_del():
    """``tree.leaves``/``flatten`` leave no cycle: with the collector off,
    a leaf dies with the last reference to the tree and the result."""
    with _no_collector():
        t = _tree()
        ref = weakref.ref(t["a"].b)
        got = tree.leaves(t)
        paths = tree.flatten(t)
        assert any(x is ref() for x in got)
        del t, got, paths
        assert ref() is None


def test_tree_map_holds_no_leaf_after_del():
    """``tree_map`` over two trees: neither an input leaf nor an output
    leaf outlives its tree."""
    with _no_collector():
        t, u = _tree(), _tree()
        ref_in = weakref.ref(t["m"]["c"][0])
        out = tree.tree_map(lambda x, y: x + y, t, u)
        ref_out = weakref.ref(out["m"]["c"][0])
        assert float(ref_out()) == 2 * float(ref_in())
        del t, u
        assert ref_in() is None
        del out
        assert ref_out() is None


def test_unflatten_holds_no_value_after_del():
    """``unflatten`` keeps no reference to the values it placed."""
    with _no_collector():
        like = _tree()
        values = [torch.full((2,), float(i)) for i in range(6)]
        ref = weakref.ref(values[3])
        out = tree.unflatten(like, values)
        assert tree.leaves(out)[3] is ref()
        del values, out
        assert ref() is None


# -- no nested function refers to itself ---------------------------------


def _self_referencing_nested_functions(root: Path) -> list:
    """``file:line outer > inner`` for each function defined inside
    another function (or method) whose body names itself."""
    found = []
    for path in sorted(root.rglob("*.py")):
        mod = ast.parse(path.read_text(), filename=str(path))
        for outer in ast.walk(mod):
            if not isinstance(outer, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for inner in ast.walk(outer):
                if inner is outer or not isinstance(
                        inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                names = {n.id for n in ast.walk(inner)
                         if isinstance(n, ast.Name)}
                if inner.name in names:
                    found.append(f"{path.relative_to(root)}:{inner.lineno} "
                                 f"{outer.name} > {inner.name}")
    return sorted(set(found))


def test_no_nested_function_refers_to_itself():
    assert _self_referencing_nested_functions(PORT) == []


def test_the_scan_finds_a_self_referencing_closure(tmp_path):
    """The scan above sees the pattern it forbids."""
    (tmp_path / "m.py").write_text(
        "def f(t):\n"
        "    out = []\n"
        "    def walk(x):\n"
        "        if isinstance(x, list):\n"
        "            for v in x:\n"
        "                walk(v)\n"
        "        else:\n"
        "            out.append(x)\n"
        "    walk(t)\n"
        "    return out\n")
    assert _self_referencing_nested_functions(tmp_path) == ["m.py:3 f > walk"]


# -- the tree order is the reference's -----------------------------------


def test_tree_order_matches_jax_tree_util():
    """Leaves in ``jax.tree_util``'s order (sorted keys, NamedTuple fields
    in declaration order, ``None`` skipped), with paths of keys, field
    names and indices."""
    t = _tree()
    got = [float(x) for x in tree.leaves(t)]
    jt = jax.tree_util.tree_map(lambda x: float(x), t)
    assert got == jax.tree_util.tree_leaves(jt)
    assert [p for p, _ in tree.flatten(t)] == [
        ("a", "b"), ("a", "a", "y"), ("m", "c", 0), ("m", "k"), ("z", 0),
        ("z", 2, 0)]


def test_unflatten_rebuilds_the_structure():
    """Types (NamedTuple, list, tuple), ``None`` subtrees and sorted keys
    come back; surplus values raise ``ValueError``."""
    t = _tree()
    values = [torch.tensor(float(i)) for i in range(6)]
    out = tree.unflatten(t, values)
    assert isinstance(out["a"], Pair) and out["a"].a["x"] is None
    assert out["z"][1] is None and isinstance(out["z"][2], tuple)
    assert isinstance(out["z"], list) and list(out) == ["a", "m", "z"]
    assert [float(x) for x in tree.leaves(out)] == list(range(6))
    with pytest.raises(ValueError, match="more values"):
        tree.unflatten(t, values + [torch.tensor(6.0)])
    mapped = tree.tree_map(lambda x: 2 * x, t)
    assert [float(x) for x in tree.leaves(mapped)] == [
        2 * float(x) for x in tree.leaves(t)]


# -- the main paths leave no tensor to the collector ---------------------


def _wiener(records=None):
    model = WienerVelocityConfig().model()
    ts = time_grid(0.0, 2.0, 40)
    if records:
        ts = ts[:, None].expand(41, records).contiguous()
    _, y = simulate_linear(model, ts, torch.Generator().manual_seed(0))
    return model, ts, y


def _solve(method, options):
    model, ts, y = _wiener()
    est = Estimator(model, method=method, options=options, device="cpu",
                    cache=ExecutableCache())
    return est.solve(Problem.single(model, ts, y))


def _trajectory_wave():
    model, ts, y = _wiener()
    eng = TrajectoryEngine(model, batch=2, device="cpu", options=(
        ParallelOptions(nsub=NSUB, mode="discrete")))
    for _ in range(2):
        eng.submit(ts.numpy(), y.numpy())
    assert eng.step() == 2
    return eng.collect()


def _streaming_wave():
    model, ts, y = _wiener()
    eng = StreamingEngine(model, lag=8, batch=2, device="cpu", options=(
        ParallelOptions(nsub=NSUB, mode="discrete")))
    ts, y = ts.numpy(), y.numpy()
    tracks = [eng.open_track() for _ in range(2)]
    for tid in tracks:
        eng.push(tid, ts[1:21], y[:20])
    assert eng.step() == 2
    return [eng.window(tid) for tid in tracks]


def _lm():
    cfg = dataclasses.replace(tconfig.get_config(ARCH), dtype="float32")
    return cfg, transformer.init(cfg, torch.Generator().manual_seed(0))


def _batch(cfg):
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
            for k in ("tokens", "labels")}


TCFG = dict(total_steps=4, warmup_steps=1)


def _train_step():
    cfg, params = _lm()
    return make_train_step(cfg, tconfig.TrainConfig(**TCFG))(
        params, t_opt.adamw_init(params), _batch(cfg))


def _mesh():
    return Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "model"))


def _sharded_state():
    cfg, params = _lm()
    tcfg = tconfig.TrainConfig(**TCFG)
    mesh = _mesh()
    with mesh_context(mesh):
        shardings = make_shardings(cfg, tcfg, mesh)
    state = spmd.device_put((params, t_opt.adamw_init(params)), shardings)
    return cfg, tcfg, mesh, shardings, state


def _sharded_train_step():
    cfg, tcfg, mesh, _, state = _sharded_state()
    batch = _batch(cfg)
    with mesh_context(mesh):
        specs = tree.tree_map(lambda x: shd.named_sharding(
            x.shape, ("batch",) + (None,) * (x.dim() - 1)), batch)
        return make_train_step(cfg, tcfg)(*state,
                                          spmd.device_put(batch, specs))


def _serve():
    cfg, params = _lm()
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=3) for _ in range(2)]
    return ServeEngine(cfg, params, batch=2, max_len=16,
                       device="cpu").generate(reqs)


def _sharded_checkpoint(workdir):
    _, _, _, shardings, state = _sharded_state()
    path = ckpt.save_checkpoint(str(workdir), 1, state)
    _, params = _lm()
    return ckpt.restore_checkpoint(
        path, (params, t_opt.adamw_init(params)), shardings)


PATHS = {
    "solve-parallel_kernel": lambda _: _solve(
        "parallel_kernel", KernelOptions(nsub=NSUB, mode="discrete")),
    "solve-parallel_rts": lambda _: _solve(
        "parallel_rts", ParallelOptions(nsub=NSUB, mode="discrete")),
    "trajectory-engine-wave": lambda _: _trajectory_wave(),
    "streaming-engine-wave": lambda _: _streaming_wave(),
    "train-step": lambda _: _train_step(),
    "train-step-sharded-2x2": lambda _: _sharded_train_step(),
    "serve-prefill-decode": lambda _: _serve(),
    "sharded-checkpoint-save-restore": _sharded_checkpoint,
}


def _garbage_tensors(run) -> list:
    """The tensors among what the collector finds unreachable after
    ``run()`` and the deletion of its result, with the collector off
    during the run."""
    gc.collect()
    gc.garbage.clear()
    with _no_collector():
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            out = run()
            assert out is not None
            del out
            gc.collect()
            return [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        finally:
            gc.set_debug(0)
            gc.garbage.clear()


@pytest.mark.parametrize("name", list(PATHS))
def test_path_leaves_no_tensor_to_the_collector(name, tmp_path):
    """One run of the path first: a path's first call in a process imports
    torch modules lazily (``torch.utils.checkpoint`` imports
    ``torch._dynamo``), and ``torch.fx.wrap``, run at that import, keeps
    its own frame in a cycle that holds the calling stack once per
    process.  The second run must leave nothing to the collector."""
    run = PATHS[name]
    run(tmp_path / "warm")
    found = _garbage_tensors(lambda: run(tmp_path / "run"))
    assert found == [], (
        f"{len(found)} tensors of {sum(t.numel() for t in found)} elements "
        f"only the collector frees")
