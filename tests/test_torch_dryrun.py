"""The port's dry-run (``repro_torch.launch.dryrun``, on meshes of ``meta``
devices), its HLO parser (``repro_torch.launch.hlo_parse``) and
``chunked_mha``'s ``causal_skip``, against the JAX package.

The reference's side runs in ONE subprocess with 8 forced host devices:
it compiles a small sharded function (a ``fori_loop`` whose body holds
all five collective kinds) and returns its HLO text; it runs its own
``launch/dryrun.py::run_cell`` on a small train cell on a (2, 2) mesh of
those devices (``make_production_mesh`` and ``SHAPE_SUITE`` patched to
that mesh and cell), also with ``parallel_policy=dp_only`` and with
``seq_parallel=true``, and on a skipped cell; and it gives XLA's FLOPs for
``tests/test_roofline_model.py``'s loop-free ``CASES``.  The port's
run_cell is patched the same way, on a (2, 2) mesh of ``meta`` devices.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.launch import hlo_parse as j_hlo
from repro.models import attention as j_attn
from repro_torch import config as tconfig
from repro_torch.configs import ARCHS
from repro_torch.distributed import Mesh, spmd
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_parse as t_hlo
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = dict(rtol=2e-4, atol=2e-4)
TINY = "smollm-135m-smoke"
# a train cell of 16 x 32 tokens (2 rows a data group at 8 microbatches)
TINY_SHAPES = (("tiny_train", "train", 32, 16),
               ("tiny_prefill", "prefill", 32, 4),
               ("tiny_decode", "decode", 64, 4))


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jax.clear_caches()
    gc.collect()


_REFERENCE = """
import os, sys, json, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
devices = jax.devices()
TINY, SHAPES, CASES_FROM = json.loads(sys.argv[1])

# 1. a sharded loop with all five collective kinds
mesh = Mesh(np.asarray(devices[:8]).reshape(4, 2), ("x", "y"))

def body(i, c):
    a, b = c
    s = jax.lax.psum(a, "x")
    g = jax.lax.all_gather(b, "y", tiled=True)
    r = jax.lax.psum_scatter(g, "y", tiled=True)
    t = jax.lax.all_to_all(a, "x", 0, 0, tiled=True)
    p = jax.lax.ppermute(b, "x", [(j, (j + 1) % 4) for j in range(4)])
    return (s * 0.5 + t, r + p)

def f(a, b):
    a, b = jax.lax.fori_loop(0, 3, body, (a, b))
    return a, jax.lax.psum(b, ("x", "y"))

sf = shard_map(f, mesh=mesh, in_specs=(P("x", None), P(None, "y")),
               out_specs=(P("x", None), P(None, None)), check_rep=False)
hlo = jax.jit(sf).lower(jax.ShapeDtypeStruct((32, 16), jnp.float32),
                        jax.ShapeDtypeStruct((8, 8), jnp.bfloat16)
                        ).compile().as_text()

# 2. the reference's run_cell on a small cell and mesh
import repro.config as cfgmod
import repro.launch.mesh as meshmod
from repro.launch import dryrun
cfgmod.SHAPE_SUITE = cfgmod.SHAPE_SUITE + tuple(
    cfgmod.ShapeConfig(*s) for s in SHAPES)
meshmod.make_production_mesh = lambda multi_pod=False: Mesh(
    np.asarray(devices[:4]).reshape(2, 2), ("data", "model"))
out = tempfile.mkdtemp()
train = dryrun.run_cell(TINY, "tiny_train", False, out)
dp_only = dryrun.run_cell(TINY, "tiny_train", False, out,
                          overrides={"parallel_policy": "dp_only"})
seq_parallel = dryrun.run_cell(TINY, "tiny_train", False, out,
                               overrides={"seq_parallel": "true"})
skipped = dryrun.run_cell("hubert-xlarge-smoke", "decode_32k", False, out)

# 3. XLA's FLOPs on the loop-free cases
sys.path.insert(0, CASES_FROM)
from benchmarks.flops import xla_cost_analysis
from test_roofline_model import CASES
from repro.config import ShapeConfig, TrainConfig
from repro.models import transformer
from repro.train.optimizer import adamw_init
from repro.train.trainer import make_train_step
flops = {}
for name, cfg in CASES.items():
    batch = {"tokens": jax.ShapeDtypeStruct((2, 128), jnp.int32),
             "labels": jax.ShapeDtypeStruct((2, 128), jnp.int32)}
    params = jax.eval_shape(lambda: transformer.init(
        cfg, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda: adamw_init(transformer.init(
        cfg, jax.random.PRNGKey(0))))
    compiled = jax.jit(make_train_step(cfg, TrainConfig())).lower(
        params, opt, batch).compile()
    flops[name] = xla_cost_analysis(compiled)["flops"]
print(json.dumps({"hlo": hlo, "train": train, "skipped": skipped,
                  "dp_only": dp_only, "seq_parallel": seq_parallel,
                  "flops": flops}))
"""


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(
            [TINY, TINY_SHAPES, os.path.join(ROOT, "tests")])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC + os.pathsep + ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cases():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_roofline_model import CASES
    return {k: tconfig.ModelConfig(**dataclasses.asdict(v))
            for k, v in CASES.items()}


def _meta_mesh(shape) -> Mesh:
    return Mesh(np.array(["meta"] * int(np.prod(shape)), dtype=object
                         ).reshape(shape), ("data", "model"))


@pytest.fixture
def tiny_cells(monkeypatch):
    """The port's run_cell on the tiny cells, on a (2, 2) meta mesh."""
    monkeypatch.setattr(tconfig, "SHAPE_SUITE", tconfig.SHAPE_SUITE + tuple(
        tconfig.ShapeConfig(*s) for s in TINY_SHAPES))
    monkeypatch.setattr(t_mesh, "make_production_mesh",
                        lambda multi_pod=False, devices=None: _meta_mesh(
                            (2, 2)))


# ---------------------------------------------------------------------------
# hlo_parse
# ---------------------------------------------------------------------------


def test_hlo_parse_matches_reference_on_reference_hlo(reference):
    text = reference["hlo"]
    got, want = t_hlo.collective_analysis(text), j_hlo.collective_analysis(
        text)
    assert got == want
    # every kind is there, and the loop body's three runs are counted
    assert all(want["counts"][k] >= 3 for k in j_hlo.COLL_KINDS)
    assert want["counts"]["all-reduce"] == 3 + 1
    assert t_hlo.split_computations(text) == j_hlo.split_computations(text)
    for line in text.splitlines():
        assert t_hlo.shape_bytes(line) == j_hlo.shape_bytes(line)
        assert t_hlo.group_size(line) == j_hlo.group_size(line)
    assert (t_hlo.DTYPE_BYTES, t_hlo.COLL_KINDS) == (j_hlo.DTYPE_BYTES,
                                                     j_hlo.COLL_KINDS)


@pytest.mark.parametrize("kind", j_hlo.COLL_KINDS)
def test_wire_bytes_match_reference_on_every_group(kind):
    for group in (1, 2, 4, 8, 16, 256, 512):
        for nbytes in (0, 2, 4096, 13107200):
            assert t_hlo.wire_bytes(kind, nbytes, group) == \
                j_hlo.wire_bytes(kind, nbytes, group), (kind, group)


def test_log_analysis_applies_wire_bytes_to_each_entry():
    log = spmd.CollectiveLog([
        spmd.Collective("all-gather", 1000, 4),
        spmd.Collective("all-reduce", 400, 2),
        spmd.Collective("all-reduce", 400, 16),
        spmd.Collective("reduce-scatter", 64, 8)])
    got = t_hlo.log_analysis(log)
    assert set(got) == set(j_hlo.collective_analysis(""))
    assert got["out_bytes"]["all-reduce"] == 800
    assert got["counts"] == {"all-gather": 1, "all-reduce": 2,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0}
    assert got["wire_bytes"]["all-reduce"] == int(
        j_hlo.wire_bytes("all-reduce", 400, 2)
        + j_hlo.wire_bytes("all-reduce", 400, 16))
    assert got["total_out_bytes"] == 1864
    assert got["total_wire_bytes"] == sum(got["wire_bytes"].values())


def test_load_hlo_reads_zstd_and_says_what_is_missing(tmp_path, monkeypatch):
    zstd = pytest.importorskip("zstandard")
    path = tmp_path / "a.hlo.zst"
    path.write_bytes(zstd.ZstdCompressor().compress(b"HloModule m"))
    assert t_hlo.load_hlo(str(path)) == "HloModule m"
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        t_hlo.load_hlo(str(path))


# ---------------------------------------------------------------------------
# causal_skip
# ---------------------------------------------------------------------------


def _qkv(seed, B, Hq, Hkv, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


@pytest.mark.parametrize("Lq,Lk,window", [(64, 64, None), (64, 64, 24),
                                          (32, 64, None)])
def test_causal_skip_equals_the_full_schedule_and_the_reference(
        Lq, Lk, window):
    q, k, v = _qkv(0, 2, 4, 2, Lq, Lk, 8)
    kw = dict(causal=True, window=window, chunk_q=16, chunk_k=16)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    full = t_attn.chunked_mha(tq, tk, tv, **kw)
    skip = t_attn.chunked_mha(tq, tk, tv, causal_skip=True, **kw)
    assert torch.equal(skip, full)
    want = j_attn.chunked_mha(q, k, v, causal_skip=True, **kw)
    np.testing.assert_allclose(skip.numpy(), np.asarray(want), **TOL)
    # the products executed: q chunk qi visits hi(qi) of the nk kv chunks
    from torch.utils.flop_counter import FlopCounterMode
    counts = []
    for cs in (False, True):
        with FlopCounterMode(display=False) as fc:
            t_attn.chunked_mha(tq, tk, tv, causal_skip=cs, **kw)
        counts.append(fc.get_total_flops())
    off, nk = Lk - Lq, Lk // 16
    visits = sum(min(nk, (off + (qi + 1) * 16 + 15) // 16)
                 for qi in range(Lq // 16))
    assert counts[1] * (Lq // 16) * nk == counts[0] * visits
    assert counts[1] < counts[0]


def test_train_loss_with_causal_skip_is_the_same_loss():
    cfg = dataclasses.replace(tconfig.get_config(TINY), dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = t_tf.init(cfg, g)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
             for k in ("tokens", "labels")}
    a = t_tf.train_loss(params, batch, cfg)
    b = t_tf.train_loss(params, batch, cfg, causal_skip=True)
    assert torch.equal(a, b)


def test_prefill_takes_no_causal_skip_like_the_reference():
    """``make_step(**model_kw)`` hands ``causal_skip`` to ``prefill``,
    which (as the reference's) takes none."""
    cfg = tconfig.get_config(TINY)
    shape = tconfig.ShapeConfig("p", "prefill", 32, 2)
    step, specs = t_steps.make_step(cfg, shape, tconfig.TrainConfig(),
                                    causal_skip=True)
    with pytest.raises(TypeError, match="causal_skip"):
        step(**specs)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dense-gqa", "moe", "plain-mlp", "ssm"])
def test_dry_run_flops_within_the_reference_gate_of_xla(reference, case):
    """``tests/test_roofline_model.py``'s 20 % gate, on its loop-free
    cases: one (1, 1) meta run against XLA's ``cost_analysis``."""
    cfg = _cases()[case]
    shape = tconfig.ShapeConfig("val", "train", seq_len=128, global_batch=2)
    got = dryrun.measure(cfg, shape, _meta_mesh((1, 1)),
                         tconfig.TrainConfig())["cost_analysis"]["flops"]
    ratio = got / reference["flops"][case]
    assert 0.8 < ratio < 1.25, (case, got, reference["flops"][case])


@pytest.mark.parametrize("d", [2, 4])
def test_dry_run_flops_are_one_devices_share(d):
    """On a (d, 1) mesh each data group runs B/d of the rows: one device's
    FLOPs are exactly 1/d of the (1, 1) run's.  The MoE layer's expert
    GEMMs are the exception: each group's dispatch buffer holds
    min(capacity, its tokens) rows an expert (the capacity is the whole
    batch's), here all 128 on either mesh, so that part stays whole."""
    shape = tconfig.ShapeConfig("val", "train", seq_len=128, global_batch=4)
    for name, cfg in _cases().items():
        # whole-region recomputation: under torch's early stop a lone
        # group's recomputation ends before its last product, while a group
        # that others follow in the lockstep recomputes it
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            one, many = (dryrun.measure(cfg, shape, _meta_mesh((n, 1)),
                                        tconfig.TrainConfig())[
                "cost_analysis"]["flops"] for n in (1, d))
        if name != "moe":
            assert one == d * many, name
            continue
        T, E, K = 4 * 128, cfg.moe_experts, cfg.moe_topk
        cap = int(max(K, K * T / E * cfg.moe_capacity_factor))
        rows = [min(cap, T * K, T // n) for n in (1, d)]
        runs = 4 * 3 * cfg.num_layers      # fwd, recompute, 2 bwd; 3 GEMMs
        experts = [runs * 2 * E * r * cfg.d_model * cfg.d_ff for r in rows]
        assert one - experts[0] == d * (many - experts[1]), (one, many)


def test_argument_bytes_match_the_reference_memory_analysis(reference,
                                                            tiny_cells):
    """The tiny train cell on a (2, 2) mesh: parameters, optimizer state
    (zero1) and batch, one device's shards.  The port's and XLA's
    argument sizes agree to the byte: the same specs give the same local
    shapes, and both count the AdamW step counter (4 bytes)."""
    want = reference["train"]
    got = dryrun.run_cell(TINY, "tiny_train", False, "unused")
    assert want["status"] == got["status"] == "ok", want.get("error")
    assert (got["memory_analysis"]["argument_size_in_bytes"]
            == want["memory_analysis"]["argument_size_in_bytes"])


def test_record_keys_and_skip_reasons_match_the_reference(reference,
                                                          tiny_cells):
    want, got = reference["train"], dryrun.run_cell(TINY, "tiny_train",
                                                    False, "unused")
    def kept(d):
        return {k for k in d if not k.startswith(dryrun.OMITTED)}

    assert set(got) == kept(want) | {"note"}
    assert set(got["memory_analysis"]) == kept(want["memory_analysis"])
    assert set(got["cost_analysis"]) == kept(want["cost_analysis"]) == {
        "flops"}
    assert set(got["collectives"]) == kept(want["collectives"]) | {
        "wire_bytes", "total_wire_bytes"}
    for k in ("arch", "shape", "mesh", "kind", "seq_len", "global_batch",
              "params", "active_params", "tag", "overrides", "num_devices"):
        assert got[k] == want[k], k
    skipped = dryrun.run_cell("hubert-xlarge-smoke", "decode_32k", False,
                              "unused")
    assert skipped == reference["skipped"]
    for arch in ARCHS:
        for s, js in zip(tconfig.SHAPE_SUITE, jconfig.SHAPE_SUITE):
            assert tconfig.shape_skip_reason(tconfig.get_config(arch), s) \
                == jconfig.shape_skip_reason(jconfig.get_config(arch), js)


def test_dp_only_is_recorded_failed(tiny_cells):
    """dp-only cells run: train, prefill and decode are ``ok`` on the
    (2, 2) meta mesh, the batch over ("data", "model"), one position a
    data group, the table (vocab-split) all-gathered over the model
    axis.  A dp-only cell the executor cannot lay out is still recorded
    ``failed`` with its error: tiny_train at 8 microbatches has 2 rows a
    microbatch for 4 groups."""
    over = {"parallel_policy": "dp_only"}
    for shape in ("tiny_train", "tiny_prefill", "tiny_decode"):
        rec = dryrun.run_cell(TINY, shape, False, "unused", overrides=over)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["overrides"] == over
        counts = rec["collectives"]["counts"]
        assert counts["all-gather"] >= 1, shape
        if shape != "tiny_train":      # the table, once a call
            assert counts == {"all-gather": 1, "all-reduce": 0,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    rec = dryrun.run_cell(TINY, "tiny_train", False, "unused",
                          overrides=over, microbatches=8)
    assert rec["status"] == "failed"
    assert "does not divide" in rec["error"]


def test_dp_only_and_seq_parallel_cells_match_the_reference(reference,
                                                            tiny_cells):
    """The reference's tiny_train with ``parallel_policy=dp_only`` and with
    ``seq_parallel=true``: the same status, parameter count and argument
    bytes (one device's parameters, optimizer state and batch).  The SP
    record's log is the non-SP record's changed as
    ``tests/test_torch_sharding.py::test_dp_only_and_seq_parallel_logs_
    are_exact`` predicts, per microbatch (8 here): each forward run of a
    layer's two all-reduces becomes two all-gathers and two
    reduce-scatters, each layer's backward adds two of each, and the
    stream's split and gather add two all-gathers.  (XLA's own SP log is
    in ``PERF.md``; it need not equal the port's, which differs from
    XLA's without SP as well.)"""
    base = dryrun.run_cell(TINY, "tiny_train", False, "unused")
    for key, over in (("dp_only", {"parallel_policy": "dp_only"}),
                      ("seq_parallel", {"seq_parallel": "true"})):
        want = reference[key]
        got = dryrun.run_cell(TINY, "tiny_train", False, "unused",
                              overrides=over)
        assert want["status"] == got["status"] == "ok", (key, want.get(
            "error"), got.get("error"))
        assert got["params"] == want["params"]
        assert (got["memory_analysis"]["argument_size_in_bytes"]
                == want["memory_analysis"]["argument_size_in_bytes"]), key
    sp = got["collectives"]["counts"]
    b = base["collectives"]["counts"]
    assert sp != b
    cfg = tconfig.get_config(TINY)
    n, runs, mb = cfg.num_layers, 2 if cfg.remat else 1, 8
    assert sp == {**b,
                  "all-reduce": b["all-reduce"] - mb * runs * 2 * n,
                  "all-gather": b["all-gather"]
                  + mb * (runs * 2 * n + 2 * n + 2),
                  "reduce-scatter": b["reduce-scatter"]
                  + mb * (runs * 2 * n + 2 * n)}
    # the reference's XLA program changes under SP as well
    assert reference["seq_parallel"]["collectives"]["counts"] != reference[
        "train"]["collectives"]["counts"]


def test_prefill_and_decode_cells_log_the_sharded_serving_path(tiny_cells):
    """smollm-smoke at (2, 2): the meta run's collective log is the one
    ``tests/test_torch_serve_sharded.py`` predicts from the specs (the
    embedding's and per layer two all-reduces, the logits' all-gather),
    the caches are the outputs, and ``--causal-skip`` on a prefill cell
    fails with the reference's TypeError."""
    for shape in ("tiny_prefill", "tiny_decode"):
        rec = dryrun.run_cell(TINY, shape, False, "unused")
        assert rec["status"] == "ok", rec.get("error")
        assert rec["collectives"]["counts"] == {
            "all-gather": 1, "all-reduce": 5, "reduce-scatter": 0,
            "all-to-all": 0, "collective-permute": 0}
        assert rec["cost_analysis"]["flops"] > 0
    rec = dryrun.run_cell(TINY, "tiny_prefill", False, "unused",
                          model_kw={"causal_skip": True})
    assert rec["status"] == "failed" and rec["error"].startswith(
        "TypeError")


@pytest.mark.parametrize("arch,shape,microbatches,nested,early_stop", [
    ("hymba-1.5b-smoke", (2, 2), 1, False, True),
    (TINY, (4, 2), 2, False, True),
    ("granite-moe-3b-a800m-smoke", (2, 5), 2, False, True),
    (TINY, (2, 2), 1, True, True), (TINY, (2, 2), 1, True, False)])
def test_meta_train_step_logs_what_a_cpu_step_logs(arch, shape, microbatches,
                                                   nested, early_stop):
    """The sharded train step on a mesh of ``meta`` devices (where the
    first data group and model shard stand for the others) logs the
    collectives of the same step on a mesh of ``cpu`` devices, entry for
    entry: with per-layer remat and nested remat groups (4 layers in
    groups of 2), under torch's early stop of a recomputation and
    without it."""
    import contextlib

    from repro_torch import tree
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import optimizer as t_opt
    from repro_torch.train.trainer import make_shardings, make_train_step

    cfg = tconfig.get_config(arch)
    if nested:
        cfg = dataclasses.replace(cfg, num_layers=4, remat_group=2)
    tcfg = tconfig.TrainConfig(total_steps=4, warmup_steps=1,
                               microbatches=microbatches)
    logs = {}
    for dev in ("cpu", "meta"):
        g = torch.Generator().manual_seed(0)
        params = tree.tree_map(lambda x: x.to(dev), t_tf.init(cfg, g))
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=g
                                  ).to(dev) for k in ("tokens", "labels")}
        mesh = Mesh(np.array([dev] * int(np.prod(shape)), dtype=object
                             ).reshape(shape), ("data", "model"))
        run = dryrun.MetaRun() if dev == "meta" else contextlib.nullcontext()
        with mesh_context(mesh), run, \
                torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
            p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
            b_sh = tree.tree_map(lambda x: shd.named_sharding(
                x.shape, ("batch",) + (None,) * (x.dim() - 1)), batch)
            _, _, m = make_train_step(cfg, tcfg)(
                spmd.device_put(params, p_sh),
                spmd.device_put(t_opt.adamw_init(params), o_sh),
                spmd.device_put(batch, b_sh))
        logs[dev] = list(m["collectives"])
    assert logs["meta"] == logs["cpu"]


def test_cli_writes_the_reference_file_names(tiny_cells, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", TINY, "--shape", "tiny_decode", "--out",
                     str(tmp_path), "--tag", "t"])
    assert e.value.code == 0
    rec = json.loads((tmp_path / f"pod256--{TINY}--tiny_decode-t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["tag"] == "t"
    assert capsys.readouterr().out.startswith(
        f"[dryrun] pod256 {TINY} tiny_decode: ok flops=")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", TINY, "--shape", "tiny_train", "--out",
                     str(tmp_path), "--set", "parallel_policy=dp_only"])
    assert e.value.code == 0
