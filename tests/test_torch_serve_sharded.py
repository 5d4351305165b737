"""Sharded prefill and decode (``repro_torch.distributed.spmd``) against the
port's single-device run and the JAX package.

The reference runs ``prefill``/``decode_step`` unmodified on a mesh: its
``jax.jit`` partitions the program over the sharded inputs and lays the
caches out by ``launch/steps.py::cache_pspecs``.  Here the port's sharded
``prefill`` and ``decode_step`` run on ("data", "model") meshes of ``cpu``
devices, on the params of ``make_shardings`` and a batch split over
``batch``, and return caches laid out by the port's ``cache_pspecs``.
Held, in float32, at ``tests/test_torch_lm.py``'s ``TOL`` (rtol 2e-4 /
atol 2e-4): the last position's logits and every cache field (gathered)
after prefill, and the logits and caches after one and three decode
steps, against the port on one device and the reference's jitted
``prefill``/``decode_step``; every shard of a cache equal to its slice of
the gathered cache (replicas included).

Configs: hymba-1.5b-smoke (hybrid; at model 2 its one kv head forces the
``head_dim`` fallback: kv split over ``hd``, the SSM state over heads, the
conv tail over channels), granite-moe-3b-a800m-smoke (MoE; head-local
attention at model 2, kv over ``hd`` at model 4) and smollm-135m-smoke
(attention only).
"""
import dataclasses
import functools
import gc

import jax
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get_config
from repro.models import transformer as j_tf
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import tree
from repro_torch.config import TrainConfig, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import Mesh, mesh_context, spmd
from repro_torch.distributed import sharding as shd
from repro_torch.launch.steps import cache_layout, cache_pspecs
from repro_torch.models import transformer as t_tf
from repro_torch.serving import Request, ServeEngine
from repro_torch.train.trainer import make_shardings

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
HYMBA, GRANITE, SMOLLM = ("hymba-1.5b-smoke", "granite-moe-3b-a800m-smoke",
                          "smollm-135m-smoke")
B, L, MAX_LEN = 8, 48, 64


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jax.clear_caches()
    gc.collect()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _mesh(shape) -> Mesh:
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                ("data", "model"))


@functools.lru_cache(maxsize=None)
def _model(name):
    jcfg = dataclasses.replace(j_get_config(name), dtype="float32")
    tcfg = dataclasses.replace(get_config(name), dtype="float32")
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, nparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _reference(name, batch):
    """The reference's logits and caches after prefill and after each of
    three decode steps (the greedy tokens of its own logits)."""
    jcfg, _, jparams, _ = _model(name)
    toks = _tokens(3, (batch, L), jcfg.vocab_size)
    logits, caches = jax.jit(lambda p, t: j_tf.prefill(
        p, {"tokens": t}, jcfg, MAX_LEN))(jparams, toks)
    decode = jax.jit(lambda p, t, c: j_tf.decode_step(p, t, c, jcfg))
    out = [(np.asarray(logits), jax.tree_util.tree_map(np.asarray, caches))]
    cur = np.asarray(np.argmax(out[0][0][:, -1], axis=-1), np.int32)
    steps = []
    for _ in range(3):
        logits, caches = decode(jparams, cur, caches)
        out.append((np.asarray(logits),
                    jax.tree_util.tree_map(np.asarray, caches)))
        steps.append(cur)
        cur = np.asarray(np.argmax(out[-1][0], axis=-1), np.int32)
    return toks, steps, out


def _fields(caches) -> dict:
    return {f"{name}.{field}": a
            for name in ("attn", "ssm") if getattr(caches, name) is not None
            for field, a in zip(getattr(caches, name)._fields,
                                getattr(caches, name))}


def _gathered(caches) -> dict:
    """Every cache field gathered to the CPU, after checking that each
    position's shard is its slice of the whole (replicas included)."""
    out = {}
    for k, x in _fields(caches).items():
        whole = spmd.gather(x, "cpu")
        for pos in np.ndindex(x.shards.shape):
            assert torch.equal(x.shards[pos], whole[x.index(pos)]), (k, pos)
        out[k] = whole
    return out


def _close(got, want, label):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               err_msg=label, **TOL)


def _close_caches(got: dict, want, label):
    for k, w in _fields(want).items():
        _close(got[k], w, f"{label} {k}")


def _sharded_run(name, shape, toks, steps, policy="tp"):
    """The sharded prefill and three decode steps on the given tokens,
    under the mesh context of ``policy``: ``[(logits, caches gathered,
    collective log)]``."""
    _, cfg, _, nparams = _model(name)
    mesh = _mesh(shape)
    out = []
    with mesh_context(mesh, **shd.policy_kw(policy)):
        p_sh, _ = make_shardings(cfg, TrainConfig(), mesh)
        params = spmd.device_put(lm_params_from_numpy(nparams), p_sh)
        batch = torch.as_tensor(toks)
        log = spmd.CollectiveLog()
        with spmd.recording(log):
            logits, caches = t_tf.prefill(params, {"tokens": spmd.device_put(
                batch, shd.named_sharding(batch.shape, ("batch", None)))},
                cfg, MAX_LEN)
        specs = cache_layout(cfg, mesh, batch.shape[0])
        if policy == "tp":
            assert specs == cache_pspecs(cfg, mesh, batch.shape[0])
        for (k, x), (_, sp) in zip(_fields(caches).items(),
                                   _fields(specs).items()):
            assert x.sharding.spec == sp, k
        out.append((spmd.gather(logits, "cpu"), _gathered(caches), log))
        for cur in steps:
            t = torch.as_tensor(cur)
            log = spmd.CollectiveLog()
            with spmd.recording(log):
                logits, caches = t_tf.decode_step(params, spmd.device_put(
                    t, shd.named_sharding(t.shape, ("batch",))), caches, cfg)
            out.append((spmd.gather(logits, "cpu"), _gathered(caches), log))
    return out


def _single_run(name, toks, steps):
    _, cfg, _, nparams = _model(name)
    params = lm_params_from_numpy(nparams)
    logits, caches = t_tf.prefill(params, {"tokens": torch.as_tensor(toks)},
                                  cfg, MAX_LEN)
    out = [(logits, {k: v.clone() for k, v in _fields(caches).items()})]
    for cur in steps:
        logits, caches = t_tf.decode_step(params, torch.as_tensor(cur),
                                          caches, cfg)
        out.append((logits, {k: v.clone() for k, v in
                             _fields(caches).items()}))
    return out


@pytest.mark.parametrize("name,shape", [
    (HYMBA, (1, 1)), (HYMBA, (2, 2)), (HYMBA, (2, 4)),
    (GRANITE, (2, 2)), (GRANITE, (2, 4)),
    (SMOLLM, (2, 2)), (SMOLLM, (2, 4)),
])
def test_sharded_prefill_and_decode_match_single_device_and_reference(
        name, shape):
    toks, steps, want = _reference(name, B)
    got = _sharded_run(name, shape, toks, steps)
    single = _single_run(name, toks, steps)
    for i in (0, 1, 3):                       # prefill, one and three steps
        (logits, caches, _), (jl, jc), (sl, sc) = got[i], want[i], single[i]
        label = f"{name} {shape} step {i}"
        _close(logits, jl, label)
        _close(logits, _np(sl), label + " vs single-device")
        _close_caches(caches, jc, label)
        for k, v in sc.items():
            _close(caches[k], _np(v), f"{label} {k} vs single-device")
        if "attn.pos" in caches:
            assert caches["attn.pos"].tolist() == [L + i] * len(
                caches["attn.pos"])


def test_specs_force_the_head_dim_fallback():
    """The meshes above take every layout ``cache_pspecs`` has: kv over
    ``hd`` (hymba's one kv head at model 2; granite's two at model 4), kv
    over heads (granite and smollm at model 2), the SSM state over heads
    and the conv tail over channels (hymba)."""
    with mesh_context(_mesh((2, 2))):
        h = cache_pspecs(get_config(HYMBA), _mesh((2, 2)), B)
        g = cache_pspecs(get_config(GRANITE), _mesh((2, 2)), B)
    assert h.attn.k == (None, "data", None, None, "model")
    assert h.ssm.conv == (None, "data", None, "model")
    assert h.ssm.state == (None, "data", "model", None, None)
    assert g.attn.k == (None, "data", "model", None, None)
    g4 = cache_pspecs(get_config(GRANITE), _mesh((2, 4)), B)
    assert g4.attn.k == (None, "data", None, None, "model")


def test_batch_one_runs_one_group_and_fills_every_replica():
    """long_500k's batch of 1: ``cache_pspecs`` falls back to no data axis,
    the groups that hold the same row run once (the first), and every
    position's shard (the other groups' replicas included) holds the
    result; hymba at (2, 2), against the reference."""
    toks, steps, want = _reference(HYMBA, 1)
    got = _sharded_run(HYMBA, (2, 2), toks, steps)
    for i in (0, 1, 3):
        _close(got[i][0], want[i][0], f"step {i}")
        _close_caches(got[i][1], want[i][1], f"step {i}")


def _counts(log) -> dict:
    return {k: n for k, (n, _) in log.by_kind().items()}


def test_collective_log_counts_are_predicted_from_the_specs():
    """The logs of a prefill and a decode step at (2, 2), one device's
    schedule, from the specs above.

    smollm (embed and wq/wk/wv/wo head-local, kv over heads, MLP on
    ``ff``, tied embeddings on ``vocab``): the embedding's all-reduce, per
    layer one all-reduce of the heads' ``wo`` partials and one of the
    MLP's, the logits' all-gather; prefill fills the cache per shard from
    its own heads (no collective) and decodes the same way.

    hymba (q/k/v and ``wo`` on ``head``, kv over ``hd``, ``w_in`` and the
    SSM vectors gathered): prefill per layer gathers q, k, v (3) and the
    cache's k, v again (2), ``w_in``, ``conv_w``, ``conv_b``, ``dt_bias``,
    ``A_log``, ``D_skip``, ``gate_norm`` (7), and all-reduces ``wo``'s,
    ``w_out``'s and the MLP's partials (3); decode per layer gathers q, k,
    v (3), the same seven weights, the conv activations (channels) and
    the state's output (heads), and all-reduces the ``hd`` shards' partial
    scores, ``wo``'s, ``w_out``'s and the MLP's partials (4).  Both add
    the embedding's all-reduce and the logits' all-gather."""
    for name, prefill, decode in (
            (SMOLLM, {"all-reduce": 1 + 2 * 2, "all-gather": 1},
             {"all-reduce": 1 + 2 * 2, "all-gather": 1}),
            (HYMBA, {"all-reduce": 1 + 2 * 3, "all-gather": 1 + 2 * 12},
             {"all-reduce": 1 + 2 * 4, "all-gather": 1 + 2 * 12})):
        toks, steps, _ = _reference(name, B)
        got = _sharded_run(name, (2, 2), toks, steps[:1])
        assert _counts(got[0][2]) == prefill, name
        assert _counts(got[1][2]) == decode, name
        assert {c.group for c in got[0][2]} == {2}
    # smollm's decode: the logits (4 rows x 128 float32) gathered over
    # vocab, the wo partials (4 x 1 x 64 float32) summed over model
    toks, steps, _ = _reference(SMOLLM, B)
    log = _sharded_run(SMOLLM, (2, 2), toks, steps[:1])[1][2]
    assert ("all-gather", 4 * 128 * 4, 2) in log
    assert ("all-reduce", 4 * 64 * 4, 2) in log


@pytest.mark.parametrize("name", [HYMBA, GRANITE])
def test_sharded_serve_engine_matches_reference_engine(name):
    """6 requests of unequal prompts at batch 4 (two waves, left padding)
    through a ``ServeEngine`` on params sharded over a (2, 2) mesh, under
    its ``mesh_context``: the reference engine's tokens."""
    jcfg, cfg, jparams, nparams = _model(name)
    rng = np.random.default_rng(6)
    lens, new = (12, 7, 20, 16, 9, 5), (4, 6, 3, 5, 2, 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    want = JServeEngine(jcfg, jparams, batch=4, max_len=MAX_LEN).generate(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    mesh = _mesh((2, 2))
    with mesh_context(mesh):
        p_sh, _ = make_shardings(cfg, TrainConfig(), mesh)
        params = spmd.device_put(lm_params_from_numpy(nparams), p_sh)
        engine = ServeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                             device="cpu", use_kernel=False)
        got = engine.generate([Request(prompt=p, max_new_tokens=m)
                               for p, m in zip(prompts, new)])
    for g, w, m in zip(got, want, new):
        assert g.out.shape == (m,)
        np.testing.assert_array_equal(g.out, w.out)
    with pytest.raises(ValueError, match="mesh_context"):
        engine.generate([Request(prompt=prompts[0], max_new_tokens=2)])


def test_sharded_params_take_no_tree_of_plain_tokens():
    """A sharded prefill takes its batch as ShardedTensors on the params'
    mesh, as the sharded train step does."""
    _, cfg, _, nparams = _model(SMOLLM)
    mesh = _mesh((2, 2))
    with mesh_context(mesh):
        p_sh, _ = make_shardings(cfg, TrainConfig(), mesh)
        params = spmd.device_put(lm_params_from_numpy(nparams), p_sh)
        with pytest.raises(ValueError, match="batch of ShardedTensors"):
            t_tf.prefill(params, {"tokens": torch.zeros(
                (B, L), dtype=torch.int32)}, cfg, MAX_LEN)
    assert tree.leaves(params)[0].mesh is mesh


# ---------------------------------------------------------------------------
# the dp-only policy: the batch over ("data", "model")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    (HYMBA, (4, 2)), (GRANITE, (4, 2)), (SMOLLM, (4, 2)), (SMOLLM, (2, 2)),
])
def test_dp_only_prefill_and_decode_match_single_device_and_reference(
        name, shape):
    """Under dp-only every weight but the vocab-split table is replicated
    and each position runs its own rows (one row a position at (4, 2),
    two at (2, 2)): the logits and caches of prefill and three decode
    steps against the single-device run and the reference."""
    toks, steps, want = _reference(name, B)
    got = _sharded_run(name, shape, toks, steps, policy="dp_only")
    single = _single_run(name, toks, steps)
    for i in (0, 1, 3):
        (logits, caches, _), (jl, jc), (sl, sc) = got[i], want[i], single[i]
        label = f"dp-only {name} {shape} step {i}"
        _close(logits, jl, label)
        _close(logits, _np(sl), label + " vs single-device")
        _close_caches(caches, jc, label)
        for k, v in sc.items():
            _close(caches[k], _np(v), f"{label} {k} vs single-device")


def test_dp_only_caches_follow_the_batch_and_the_log_is_the_table():
    """dp-only lays each cache's batch over ("data", "model") and splits
    nothing over the model axis (``cache_layout``; the reference's
    ``cache_pspecs`` keeps kv on the model axis).  smollm's one collective
    a call is the vocab-split table's all-gather (its 128 x 64 float32
    rows, over the model axis's 2), made once and read by both the
    embedding and the tied logits."""
    mesh = _mesh((4, 2))
    with mesh_context(mesh, **shd.policy_kw("dp_only")):
        h = cache_layout(get_config(HYMBA), mesh, B)
        s = cache_layout(get_config(SMOLLM), mesh, B)
    rows = ("data", "model")
    assert h.attn.k == (None, rows, None, None, None)
    assert h.ssm.conv == (None, rows, None, None)
    assert h.ssm.state == (None, rows, None, None, None)
    assert s.attn.k == (None, rows, None, None, None)
    assert cache_pspecs(get_config(SMOLLM), mesh, B).attn.k == (
        None, "data", "model", None, None)
    toks, steps, _ = _reference(SMOLLM, B)
    got = _sharded_run(SMOLLM, (4, 2), toks, steps[:1], policy="dp_only")
    for _, _, log in got:
        assert list(log) == [("all-gather", 128 * 64 * 4, 2)]


@pytest.mark.parametrize("name", [SMOLLM, HYMBA])
def test_dp_only_serve_engine_matches_reference_engine(name):
    """The engine's waves of 4 on a (2, 2) mesh under dp-only (one row a
    position): the reference engine's tokens."""
    jcfg, cfg, jparams, nparams = _model(name)
    rng = np.random.default_rng(7)
    lens, new = (12, 7, 20, 16, 9, 5), (4, 6, 3, 5, 2, 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    want = JServeEngine(jcfg, jparams, batch=4, max_len=MAX_LEN).generate(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    mesh = _mesh((2, 2))
    with mesh_context(mesh, **shd.policy_kw("dp_only")):
        p_sh, _ = make_shardings(cfg, TrainConfig(), mesh)
        assert p_sh["embed"].spec == ("model", None)
        assert not any(p_sh["layers"]["attn"]["wq"].spec)
        params = spmd.device_put(lm_params_from_numpy(nparams), p_sh)
        got = ServeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                          device="cpu", use_kernel=False).generate(
            [Request(prompt=p, max_new_tokens=m)
             for p, m in zip(prompts, new)])
    for g, w, m in zip(got, want, new):
        assert g.out.shape == (m,)
        np.testing.assert_array_equal(g.out, w.out)
