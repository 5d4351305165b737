"""The port's logical sharding rules and sharded training step against the
JAX package.

Rules: ``transformer.axes``/``shapes`` against the reference's on every
architecture's smoke config; ``make_shardings`` (parameters and the
optimizer state, zero1 on and off), ``tree_pspecs``, ``cache_pspecs`` at
every ``SHAPE_SUITE`` global batch and the batch specs on every full
config, on meshes (1, 1), (4, 2), (16, 16) and (2, 16, 16), under the
default policy and dp-only, held for equality with the reference run in
one subprocess with 512 forced host devices (``launch/dryrun.py``'s own
setting).

Execution: the sharded step (``repro_torch.distributed.spmd``) on meshes of
``cpu`` devices against the port's single-device step and the reference's
``jax.jit(make_train_step)`` on the same weights and batch, in float32, at
the reference test's own tolerances (``tests/test_distributed.py``:
``test_sharded_train_step_matches_single_device``): loss rtol 1e-5 / atol
1e-6, parameters rtol 5e-4 / atol 5e-5.  The collective log's counts by
kind are predicted from the specs.
"""
import dataclasses
import gc
import json
from collections import Counter
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import transformer as j_tf
from repro.models.layers import params_axes, params_shapes
from repro.train import optimizer as j_opt
from repro.train import trainer as j_trainer
from repro_torch import config as tconfig
from repro_torch import tree
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import Mesh, mesh_context, spmd
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import make_shardings, make_train_step

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
B, S = 8, 32


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jax.clear_caches()
    gc.collect()


def _axes_leaves(t, prefix=()) -> list:
    """``[(path, leaf)]`` of a dict tree whose leaves are tuples."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _axes_leaves(t[k],
                                                          prefix + (k,))]
    return [(prefix, t)]


def _spec(p) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _flat(t, prefix=()) -> dict:
    """``{path: spec as a list}`` of a tree of specs or shardings."""
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(_flat(t[k], prefix + (k,)))
        return out
    if hasattr(t, "_fields") and not hasattr(t, "spec"):
        out = {}
        for k, v in zip(t._fields, t):
            out.update(_flat(v, prefix + (k,)))
        return out
    if t is None:
        return {}
    return {"/".join(map(str, prefix)): _spec(getattr(t, "spec", t))}


# The rules on every full config, mesh and policy.  Runs in the reference
# process and in this one: ``pkg`` is ``repro`` or ``repro_torch``.
_RULES = """
def rules(pkg, mesh_of):
    import importlib
    cfgmod = importlib.import_module(pkg + ".config")
    shd = importlib.import_module(pkg + ".distributed.sharding")
    tf = importlib.import_module(pkg + ".models.transformer")
    steps = importlib.import_module(pkg + ".launch.steps")
    trainer = importlib.import_module(pkg + ".train.trainer")
    ARCHS = importlib.import_module(pkg + ".configs").ARCHS
    out = {}
    policies = {"tp": {}, "dp_only": dict(
        batch_axes=("pod", "data", "model"),
        tp_exclude=frozenset(shd.MODEL_PRIORITY) - {"vocab", "embed_model"})}
    for mname, (shape, names) in MESHES.items():
        mesh = mesh_of(shape, names)
        for pname, kw in policies.items():
            with shd.mesh_context(mesh, **kw):
                for arch in ARCHS:
                    cfg = cfgmod.get_config(arch)
                    key = f"{mname}/{pname}/{arch}"
                    out[key + "/pspecs"] = flat(shd.tree_pspecs(
                        tf.axes(cfg), tf.shapes(cfg)))
                    for z in (True, False):
                        p_sh, o_sh = trainer.make_shardings(
                            cfg, cfgmod.TrainConfig(zero1=z), mesh)
                        out[key + f"/params/{z}"] = flat(p_sh)
                        out[key + f"/opt/{z}"] = flat(o_sh)
                    for s in cfgmod.SHAPE_SUITE:
                        out[key + f"/cache/{s.name}"] = flat(
                            steps.cache_pspecs(cfg, mesh, s.global_batch))
                        out[key + f"/batch/{s.name}"] = {
                            k: spec(shd.choose_pspec(
                                tuple(v.shape),
                                ("batch",) + (None,) * (len(v.shape) - 1)))
                            for k, v in steps.batch_specs(cfg, s).items()}
    return out
"""

_REFERENCE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
MESHES = json.loads(sys.argv[1])

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

def flat(t, prefix=()):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(flat(t[k], prefix + (k,)))
        return out
    if hasattr(t, "_fields"):
        out = {}
        for k, v in zip(t._fields, t):
            out.update(flat(v, prefix + (k,)))
        return out
    if t is None:
        return {}
    return {"/".join(map(str, prefix)): spec(getattr(t, "spec", t))}

def mesh_of(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             tuple(names))
""" + _RULES + """
print(json.dumps(rules("repro", mesh_of)))
"""


@pytest.fixture(scope="module")
def reference_rules():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(MESHES)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_rules():
    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(["cpu"] * n).reshape(shape), names)

    scope = {"MESHES": MESHES, "spec": _spec, "flat": _flat}
    exec(textwrap.dedent(_RULES), scope)
    return scope["rules"]("repro_torch", mesh_of)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_shapes_match_reference_and_params(arch):
    """``transformer.axes``/``shapes`` are the reference's trees, and they
    match the port's initialised parameters leaf by leaf."""
    jcfg = jconfig.get_config(arch + "-smoke")
    cfg = tconfig.get_config(arch + "-smoke")
    spec = j_tf.model_spec(jcfg)
    axes, shapes = t_tf.axes(cfg), t_tf.shapes(cfg)
    assert axes == params_axes(spec)
    assert shapes == params_shapes(spec)
    params = tree.flatten(t_tf.init(cfg, torch.Generator().manual_seed(0)))
    ax, shp = _axes_leaves(axes), _axes_leaves(shapes)
    assert [path for path, _ in params] == [path for path, _ in ax]
    for (path, p), (_, a), (_, s) in zip(params, ax, shp):
        assert tuple(p.shape) == s and len(a) == p.dim(), path


def test_rules_match_reference_on_every_config_mesh_and_policy(
        reference_rules):
    got = _port_rules()
    assert got.keys() == reference_rules.keys()
    for key in got:
        assert got[key] == reference_rules[key], key
    # the fall-throughs the rules exist for
    llava = got["16x16/tp/llava-next-34b/pspecs"]
    assert llava["layers/attn/wq"] == [None, None, None, "model"]  # 56 heads
    granite = got["16x16/tp/granite-moe-3b-a800m/pspecs"]
    assert granite["layers/moe/wu"] == [None, None, None, "model"]  # 40 exp.
    assert got["4x2/tp/granite-moe-3b-a800m/pspecs"]["layers/moe/wu"] == [
        None, "model", None, None]
    long_ = got["2x16x16/tp/hymba-1.5b/cache/long_500k"]   # batch 1
    assert long_["attn/k"][1] is None
    assert got["2x16x16/tp/hymba-1.5b/cache/decode_32k"]["attn/k"][1] == [
        "pod", "data"]
    dp = got["2x16x16/dp_only/smollm-135m/batch/train_4k"]["tokens"]
    assert dp == [["data", "model"], None]          # 256 rows on 512
    opt = got["4x2/tp/smollm-135m/opt/True"]
    assert opt["m/layers/mlp/wd"] == [None, "model", "data"]
    assert got["4x2/tp/smollm-135m/opt/False"]["m/layers/mlp/wd"] == [
        None, "model", None]


def test_rules_without_a_mesh():
    assert shd.choose_pspec((4, 8), ("batch", "ff")) == ()
    x = torch.ones(3)
    assert shd.logical_constraint(x, "embed") is x
    assert shd.named_sharding((4,), ("ff",)) is None
    mesh = Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "model"))
    with mesh_context(mesh):
        assert shd.choose_pspec((100, 56, 128), ("embed", "heads", "head")
                                ) == shd.PartitionSpec(None, "model", None)
        y = shd.logical_constraint(torch.arange(8.).reshape(4, 2),
                                   "batch", "ff")
        assert isinstance(y, spmd.ShardedTensor)
        assert y.sharding.spec == ("data", "model")
        assert y.shards[1, 0].tolist() == [[4.], [6.]]
        assert y.shards[1, 1].tolist() == [[5.], [7.]]
        assert spmd.gather(y, "cpu").tolist() == [[0., 1.], [2., 3.],
                                                  [4., 5.], [6., 7.]]
        assert shd.data_parallel_size() == 2
    sh = shd.NamedSharding(mesh, shd.PartitionSpec(("data", "model")))
    assert sh.shard_shape((8, 3)) == (2, 3)
    assert sh.index((1, 0), (8, 3))[0] == slice(4, 6)


def test_estimator_batch_axes_keep_their_meaning():
    """``mesh_context(mesh, batch_axes=(axis,))``, as ``Estimator`` enters
    it, splits records over that axis only."""
    mesh = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("time", "data"))
    with mesh_context(mesh, batch_axes=("data",)):
        assert shd.data_parallel_size() == 2
        assert shd.choose_pspec((6, 3), ("batch", None)) == ("data", None)
    with mesh_context(mesh, batch_axes=()):
        assert shd.data_parallel_size() == 1


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------

def _mesh(shape) -> Mesh:
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                ("data", "model"))


def _knobs(arch) -> tuple:
    """``"name+key=value+..."``: the config name and its overrides."""
    name, *kv = arch.split("+")
    over = {}
    for k, v in (x.split("=") for x in kv):
        over[k] = {"True": True, "False": False}.get(v, v)
    return name, over


def _setup(arch, microbatches, batch=B, seq=S, **over):
    name, knobs = _knobs(arch)
    knobs.update(over, dtype="float32")
    jcfg = dataclasses.replace(jconfig.get_config(name), **knobs)
    cfg = dataclasses.replace(tconfig.get_config(name), **knobs)
    kw = dict(total_steps=4, warmup_steps=1, microbatches=microbatches)
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    jbatch = {
        "tokens": jax.random.randint(jax.random.PRNGKey(1), (batch, seq),
                                     0, jcfg.vocab_size),
        "labels": jax.random.randint(jax.random.PRNGKey(2), (batch, seq),
                                     0, jcfg.vocab_size)}
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    return (jcfg, cfg, jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw),
            jparams, jbatch, nparams, batch)


def _sharded(cfg, tcfg, nparams, batch, shape, policy="tp"):
    """One sharded step from the weights ``nparams`` under the mesh context
    of ``policy``; returns the params gathered, the optimizer state and
    the metrics."""
    mesh = _mesh(shape)
    with mesh_context(mesh, **shd.policy_kw(policy)):
        p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
        b_sh = tree.tree_map(lambda x: shd.named_sharding(
            x.shape, ("batch",) + (None,) * (x.dim() - 1)), batch)
        params = lm_params_from_numpy(nparams)
        p, o, m = make_train_step(cfg, tcfg)(
            spmd.device_put(params, p_sh),
            spmd.device_put(t_opt.adamw_init(params), o_sh),
            spmd.device_put(batch, b_sh))
    return {k: spmd.gather(v, "cpu") for k, v in tree.flatten(p)}, o, m


def _single(cfg, tcfg, nparams, batch):
    params = lm_params_from_numpy(nparams)
    return make_train_step(cfg, tcfg)(params, t_opt.adamw_init(params),
                                      batch)


def _close_params(got: dict, want, label):
    for (path, w) in tree.flatten(want):
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                   err_msg=f"{label} {path}", **PARAM_TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_train_step_matches_single_device_and_reference(
        microbatches):
    """``tests/test_distributed.py::test_sharded_train_step_matches_single_
    device``'s property: smollm-135m-smoke, float32, B = 8, S = 32, a
    ("data", "model") mesh of 4 x 2 cpu."""
    (jcfg, cfg, jtcfg, tcfg, jparams, jbatch, nparams,
     batch) = _setup("smollm-135m-smoke", microbatches)
    got, opt, m = _sharded(cfg, tcfg, nparams, batch, (4, 2))
    p1, _, m1 = _single(cfg, tcfg, nparams, batch)
    jp, _, jm = jax.jit(j_trainer.make_train_step(jcfg, jtcfg))(
        jparams, j_opt.adamw_init(jparams), jbatch)
    for want in (float(m1["loss"]), float(jm["loss"])):
        np.testing.assert_allclose(float(m["loss"]), want, **LOSS_TOL)
    _close_params(got, p1, "port")
    _close_params(got, lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp)), "reference")
    # the optimizer state's local shapes are its zero1 shapes
    split = 0
    with mesh_context(opt.m["embed"].mesh):
        zax = t_opt.opt_state_axes(t_tf.axes(cfg), t_tf.shapes(cfg), 4).m
        for (path, x), (_, ax) in zip(tree.flatten(opt.m),
                                      _axes_leaves(zax)):
            spec = shd.choose_pspec(x.shape, ax)
            assert x.sharding.spec == spec, path
            local = shd.NamedSharding(x.mesh, spec).shard_shape(x.shape)
            assert all(tuple(s.shape) == local for s in x.shards.flat), path
            split += "zero1" in ax
    assert split >= 8


@pytest.mark.parametrize("arch,shape,microbatches", [
    ("granite-moe-3b-a800m-smoke", (2, 5), 1),
    ("granite-moe-3b-a800m-smoke", (2, 5), 2),
    ("granite-moe-3b-a800m-smoke", (4, 2), 2),
    ("hymba-1.5b-smoke", (4, 2), 1),
    ("hymba-1.5b-smoke", (4, 2), 2),
    ("hymba-1.5b-smoke+ssm_fused_proj=False", (2, 2), 1),
    ("qwen3-4b-smoke+kv_replicate=True", (2, 2), 1),
    ("qwen3-4b-smoke+kv_replicate=True", (2, 4), 1),
])
def test_sharded_train_step_other_architectures(arch, shape, microbatches):
    """granite at model 5 (expert parallelism: its 5 experts split) and at
    model 2 (experts on d_ff, head-local attention); hymba at model 2 (q/k/v
    on ``head``, the SSM's ``ssm_x``/``ssm_heads`` weights gathered), also
    with per-stream SSM projections (``ssm_fused_proj=False``: ``w_x`` &c.
    split on their own axes, no gathered ``w_in``); qwen3 with
    ``kv_replicate`` (at model 2 its kv heads still split; at model 4,
    where its 2 kv heads do not divide, ``wk``/``wv`` stay whole instead
    of splitting ``head``), each against the port's single-device step and
    the reference's."""
    (jcfg, cfg, jtcfg, tcfg, jparams, jbatch, nparams,
     batch) = _setup(arch, microbatches)
    got, _, m = _sharded(cfg, tcfg, nparams, batch, shape)
    p1, _, m1 = _single(cfg, tcfg, nparams, batch)
    jp, _, jm = jax.jit(j_trainer.make_train_step(jcfg, jtcfg))(
        jparams, j_opt.adamw_init(jparams), jbatch)
    for want in (float(m1["loss"]), float(jm["loss"])):
        np.testing.assert_allclose(float(m["loss"]), want, **LOSS_TOL)
    _close_params(got, p1, "port")
    _close_params(got, lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp)), "reference")
    with mesh_context(_mesh(shape)):
        specs = shd.tree_pspecs(t_tf.axes(cfg), t_tf.shapes(cfg))
    if "ssm_fused_proj" in arch:
        ssm = specs["layers"]["ssm"]
        assert "w_in" not in ssm
        assert ssm["w_x"] == ssm["w_z"] == (None, None, "model")
        assert ssm["conv_x_w"] == (None, None, "model")
    elif "kv_replicate" in arch:
        attn = specs["layers"]["attn"]
        assert attn["wk"] == ((None, None, "model", None) if shape[1] == 2
                              else (None, None, None, None))
    elif arch.startswith("granite") and shape[1] == 5:
        assert specs["layers"]["moe"]["wu"] == (None, "model", None, None)
    elif arch.startswith("granite"):
        assert specs["layers"]["moe"]["wu"] == (None, None, None, "model")
        assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
        assert specs["layers"]["attn"]["wk"] == (None, None, "model", None)
    else:
        assert specs["layers"]["attn"]["wq"] == (None, None, None, "model")
        assert specs["layers"]["ssm"]["w_in"] == (None, None, "model")


def test_sharded_moe_routes_the_whole_batch():
    """With a capacity that drops assignments, the data groups' tokens are
    routed together: the sharded step equals the single-device one."""
    cfg = dataclasses.replace(tconfig.get_config(
        "granite-moe-3b-a800m-smoke"), dtype="float32",
        moe_capacity_factor=1.0)
    tcfg = tconfig.TrainConfig(total_steps=4, warmup_steps=1)
    g = torch.Generator().manual_seed(3)
    params = t_tf.init(cfg, g)
    nparams = tree.tree_map(lambda x: x.numpy(), params)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    xt = t_tf._embed_in(params, batch, cfg).reshape(B * S, -1)
    r = t_tf.moe_mod.route(tree.tree_map(lambda a: a[0],
                                         params["layers"]["moe"]), xt, cfg)
    assert not bool(r.keep.all())                 # this capacity drops
    got, _, m = _sharded(cfg, tcfg, nparams, batch, (4, 1))
    p1, _, m1 = _single(cfg, tcfg, nparams, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               **LOSS_TOL)
    _close_params(got, p1, "port")


def _predicted_log(cfg, tcfg, mesh) -> dict:
    """The collectives of one smollm step on a (data, model) mesh, from the
    specs: per forward run of a layer (``remat`` runs it twice) one
    all-reduce each for head-local attention and the MLP; per backward one
    all-reduce of each region's input gradient; the embedding's
    all-reduce, the logits' all-gather (and its input's all-reduce in
    backward), the loss terms' all-reduce; per parameter leaf one
    reduce-scatter into its zero1 layout (all-reduce where it has none)
    and one all-gather back; the norm's all-reduce."""
    with mesh_context(mesh):
        p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
    zero1 = [any(e == "data" for e in s.spec)
             for s in tree.leaves(o_sh.m)]
    runs = 2 if cfg.remat else 1
    n = cfg.num_layers
    assert all(s.spec[2] == "model" for s in (p_sh["layers"]["attn"]["wq"],
                                              p_sh["layers"]["attn"]["wk"]))
    ar = 1 + runs * 2 * n + 2 * n + 1 + 1 + 1 + zero1.count(False)
    return {"all-reduce": ar, "all-gather": 1 + zero1.count(True),
            "reduce-scatter": zero1.count(True)}


def test_collective_log_counts_are_exact():
    cfg = dataclasses.replace(tconfig.get_config("smollm-135m-smoke"),
                              dtype="float32")
    tcfg = tconfig.TrainConfig(total_steps=4, warmup_steps=1)
    g = torch.Generator().manual_seed(0)
    nparams = tree.tree_map(lambda x: x.numpy(), t_tf.init(cfg, g))
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    _, _, m = _sharded(cfg, tcfg, nparams, batch, (4, 2))
    log = m["collectives"]
    counts = {k: n for k, (n, _) in log.by_kind().items()}
    assert counts == _predicted_log(cfg, tcfg, _mesh((4, 2)))
    groups = {(c.kind, c.group) for c in log}
    assert ("reduce-scatter", 4) in groups and ("all-reduce", 2) in groups
    # the logits' all-gather: one data group's (2, 32, 128) float32 logits
    assert ("all-gather", 2 * S * 128 * 4, 2) in log
    # without a model axis: only the data-parallel collectives
    _, _, m = _sharded(cfg, tcfg, nparams, batch, (4, 1))
    kinds = {c.kind for c in m["collectives"]}
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter"}
    assert all(c.group == 4 for c in m["collectives"])


def test_sharded_execution_refuses_overlapping_axes():
    """The dp-only policy puts the batch on the model axis too: the
    executor runs it, each position a data group of its own, and a weight
    split over the model axis (the vocab-split table) read from the
    group's line; a mesh axis that is neither data nor model is still
    refused."""
    mesh = _mesh((2, 2))
    with mesh_context(mesh, **shd.policy_kw("dp_only")):
        layout = spmd.Layout(mesh)
        assert layout.overlap and layout.data_axes == ("data", "model")
        groups = layout.groups()
        assert [g.positions for g in groups] == [[(0, 0)], [(0, 1)],
                                                 [(1, 0)], [(1, 1)]]
        assert layout.line((1, 0)) == [(1, 0), (1, 1)]
        table = spmd.device_put(torch.arange(8.).reshape(4, 2),
                                shd.named_sharding((4, 2), ("vocab", None)))
        batch = spmd.device_put(torch.arange(4.), shd.named_sharding(
            (4,), ("batch",)))
        assert layout.model_dim(table) == 0
        assert layout.model_dim(batch) is None
        w = spmd.views({"t": table}, groups[3], layout)["t"]
        assert w.gather and w.home == groups[3].home
        log = spmd.CollectiveLog()
        with spmd.recording(log):
            got = spmd.embedding(torch.tensor([3, 0]), w)
        assert got.tolist() == [[6., 7.], [0., 1.]]
        assert list(log) == [("all-gather", 4 * 2 * 4, 2)]
        assert spmd.views(batch, groups[2], layout, data=True).tolist() == [
            2.]
    with pytest.raises(ValueError, match="data and model axes only"):
        spmd.Layout(Mesh(np.array(["cpu"] * 4).reshape(2, 2),
                         ("data", "pipe")))


# ---------------------------------------------------------------------------
# the dp-only policy and sequence parallelism
# ---------------------------------------------------------------------------

ARCHS3 = ["smollm-135m-smoke", "hymba-1.5b-smoke",
          "granite-moe-3b-a800m-smoke"]


def _reference_step(jcfg, jtcfg, jparams, jbatch):
    jp, _, jm = jax.jit(j_trainer.make_train_step(jcfg, jtcfg))(
        jparams, j_opt.adamw_init(jparams), jbatch)
    return float(jm["loss"]), lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS3)
def test_dp_only_train_step_matches_single_device_and_reference(
        arch, microbatches):
    """dp-only on a (4, 2) mesh: a batch of 16 rows over ("data",
    "model"), every position a data group (two rows, one at 2
    microbatches), the weights replicated but the vocab-split table;
    against the port's single-device step and the reference's.  The rows
    are 16 tokens long, the module's 256 tokens a step (at 16 x 32, one
    element of smollm's tied table has a gradient of rounding noise,
    ~7e-10, which AdamW's eps of 1e-8 turns into a step past
    ``PARAM_TOL``: there the port's single-device step differs from the
    reference's as well)."""
    (jcfg, cfg, jtcfg, tcfg, jparams, jbatch, nparams,
     batch) = _setup(arch, microbatches, batch=16, seq=16)
    got, opt, m = _sharded(cfg, tcfg, nparams, batch, (4, 2), "dp_only")
    p1, _, m1 = _single(cfg, tcfg, nparams, batch)
    jloss, jp = _reference_step(jcfg, jtcfg, jparams, jbatch)
    for want in (float(m1["loss"]), jloss):
        np.testing.assert_allclose(float(m["loss"]), want, **LOSS_TOL)
    _close_params(got, p1, "port")
    _close_params(got, jp, "reference")
    assert opt.m["embed"].sharding.spec == ("model", None)
    assert {c.group for c in m["collectives"]} <= {2, 8}


@pytest.mark.parametrize("arch", ARCHS3)
def test_seq_parallel_train_step_matches_non_sp_and_reference(arch):
    """``seq_parallel`` on a (2, 2) mesh: the residual stream split by
    sequence between the layers; the step equals the non-SP step, the
    single-device step and the reference's (whose ``seq_parallel`` pin is
    the identity without a mesh), and its log differs from the non-SP
    one."""
    (jcfg, cfg, jtcfg, tcfg, jparams, jbatch, nparams,
     batch) = _setup(arch, 1, seq_parallel=True)
    got, _, m = _sharded(cfg, tcfg, nparams, batch, (2, 2))
    base, _, m0 = _sharded(dataclasses.replace(cfg, seq_parallel=False),
                           tcfg, nparams, batch, (2, 2))
    p1, _, m1 = _single(cfg, tcfg, nparams, batch)
    jloss, jp = _reference_step(jcfg, jtcfg, jparams, jbatch)
    for want in (float(m0["loss"]), float(m1["loss"]), jloss):
        np.testing.assert_allclose(float(m["loss"]), want, **LOSS_TOL)
    _close_params(got, p1, "port")
    _close_params(got, jp, "reference")
    for path, x in base.items():
        np.testing.assert_allclose(got[path].numpy(), x.numpy(),
                                   err_msg=f"vs non-SP {path}", **PARAM_TOL)
    assert m["collectives"].by_kind() != m0["collectives"].by_kind()
    assert m["collectives"].by_kind()["reduce-scatter"][0] > m0[
        "collectives"].by_kind()["reduce-scatter"][0]


def _predicted_dp_only_log(cfg, tcfg, mesh, microbatches, groups) -> dict:
    """The collectives of one dp-only step, from the specs: the vocab-split
    table's all-gather (once a step, over the model axis); per microbatch,
    per parameter leaf, its gradient reduced over every group into its
    optimizer-state layout (a reduce-scatter where that layout splits it
    over a data axis, the model axis counting as one; else an
    all-reduce), and one all-to-all per batch leaf to re-cut the
    microbatches, and its loss terms' all-reduce; the norm's all-reduce; an
    all-gather back into the parameter layout for each leaf whose
    optimizer state is more split."""
    with mesh_context(mesh, **shd.policy_kw("dp_only")):
        p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
        data = set(spmd.Layout(mesh).data_axes)
    split = [any(set(shd._entry_axes(e)) & data for e in s.spec)
             for s in tree.leaves(o_sh.m)]
    gather = [int(np.prod(o.parts(len(o.spec)))) >
              int(np.prod(p.parts(len(o.spec))))
              for o, p in zip(tree.leaves(o_sh.m), tree.leaves(p_sh))]
    out = {"all-gather": 1 + sum(gather),
           "reduce-scatter": microbatches * split.count(True),
           "all-reduce": 1 + microbatches * (1 + split.count(False))}
    if microbatches > 1:
        out["all-to-all"] = 2
    return {k: v for k, v in out.items() if v}


def test_dp_only_and_seq_parallel_logs_are_exact():
    """smollm's dp-only step on (4, 2) (16 rows; 1 and 2 microbatches) and
    its ``seq_parallel`` step on (2, 2), each log predicted from the specs.

    Sequence parallelism, against the non-SP log (``_predicted_log``), per
    layer: each forward run's two all-reduces of the attention and MLP
    outputs become reduce-scatters over the sequence, and their inputs
    are all-gathered over the sequence first (2 per run); in backward,
    each output's all-gather of its gradient, each input's reduce-scatter
    of its gradient in place of the all-reduce that ``replicate`` logs,
    and the norms' weights (``ln1``, ``ln2``), now applied per block,
    all-reduce their gradients; once a step, the stream's split (backward:
    an all-gather) before the layers and its all-gather after them."""
    cfg = dataclasses.replace(tconfig.get_config("smollm-135m-smoke"),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    nparams = tree.tree_map(lambda x: x.numpy(), t_tf.init(cfg, g))
    batch = {k: torch.randint(0, cfg.vocab_size, (16, S), generator=g)
             for k in ("tokens", "labels")}
    for mb in (1, 2):
        tcfg = tconfig.TrainConfig(total_steps=4, warmup_steps=1,
                                   microbatches=mb)
        _, _, m = _sharded(cfg, tcfg, nparams, batch, (4, 2), "dp_only")
        log = m["collectives"]
        counts = {k: n for k, (n, _) in log.by_kind().items()}
        assert counts == _predicted_dp_only_log(cfg, tcfg, _mesh((4, 2)),
                                                mb, 8)
        # the table: 128 x 64 float32 rows, over the model axis's 2
        assert [c for c in log if c.group != 8] == [
            ("all-gather", 128 * 64 * 4, 2)]
    tcfg = tconfig.TrainConfig(total_steps=4, warmup_steps=1)
    b8 = {k: v[:B] for k, v in batch.items()}
    _, _, m0 = _sharded(cfg, tcfg, nparams, b8, (2, 2))
    _, _, m = _sharded(dataclasses.replace(cfg, seq_parallel=True), tcfg,
                       nparams, b8, (2, 2))
    n, runs = cfg.num_layers, 2 if cfg.remat else 1
    base = _predicted_log(cfg, tcfg, _mesh((2, 2)))
    assert {k: c for k, (c, _) in m0["collectives"].by_kind().items()
            } == base
    want = {"all-reduce": base["all-reduce"] - runs * 2 * n,
            "all-gather": base["all-gather"] + runs * 2 * n + 2 * n + 2,
            "reduce-scatter": base["reduce-scatter"] + runs * 2 * n + 2 * n}
    log = m["collectives"]
    assert {k: c for k, (c, _) in log.by_kind().items()} == want
    # entry for entry: a data group's (4, 32, 64) float32 stream is
    # all-gathered whole and reduce-scattered into halves of the
    # sequence; the norms' gradients are (64,) float32
    full = 4 * S * 64 * 4
    sp, base_log = Counter(log), Counter(m0["collectives"])
    assert sp - base_log == Counter({
        ("all-gather", full, 2): runs * 2 * n + 2 * n + 2,
        ("reduce-scatter", full // 2, 2): runs * 2 * n + 2 * n,
        ("all-reduce", 64 * 4, 2): 2 * n})
    assert base_log - sp == Counter({("all-reduce", full, 2):
                                     runs * 2 * n + 2 * n})


def test_recomputed_collectives_are_logged_from_autograd_threads():
    """On a card, autograd recomputes a checkpointed layer in its worker
    thread: the recomputation's collectives reach the step's log (and the
    gather memo) all the same.  Here the backward runs in another thread."""
    import threading

    x = torch.ones(4, requires_grad=True)
    log = spmd.CollectiveLog()
    with spmd.recording(log):
        # pow saves the all-reduce's output: the recomputation re-runs it
        y = t_tf._checkpointed(lambda a: (spmd.all_reduce(
            [a, a], a.device) ** 2).sum(), x)
    out = []
    worker = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and out[0].tolist() == [8.0] * 4
    assert [c.kind for c in log] == ["all-reduce", "all-reduce"]
