"""Checkpoints of sharded training state (``repro_torch.train.checkpoint`` on
trees of ``ShardedTensor``s) against the JAX package's training step.

smollm-135m-smoke in float32 on ("data", "model") meshes of ``cpu``
devices: one training step, a save, a restore onto the same mesh, another
mesh shape or one device, and the next step.  A file written from a
sharded state holds each leaf's global tensor (``spmd.gather``) and the
single-device state's fingerprint; every restored shard is its slice of
the saved tensor, bit for bit; the resumed step equals the uninterrupted
step on the same mesh bit for bit, and the reference's two uninterrupted
single-device steps (``jax.jit(make_train_step)`` from the same weights
and batches) at ``tests/test_torch_sharding.py``'s tolerances, those of
the reference's own sharded-step test.
"""
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro.train import trainer as j_trainer
from repro_torch import config as tconfig
from repro_torch import tree
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import Mesh, mesh_context, spmd
from repro_torch.distributed import sharding as shd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import make_shardings, make_train_step

torch.set_num_threads(1)

ARCH = "smollm-135m-smoke"
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
B, S = 8, 32
KW = dict(total_steps=4, warmup_steps=1)


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jax.clear_caches()
    gc.collect()


def _mesh(shape) -> Mesh:
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                ("data", "model"))


class Case:
    """The configs, weights, two batches and the reference's two steps."""

    def __init__(self):
        jcfg = dataclasses.replace(jconfig.get_config(ARCH), dtype="float32")
        self.cfg = dataclasses.replace(tconfig.get_config(ARCH),
                                       dtype="float32")
        self.tcfg = tconfig.TrainConfig(**KW)
        jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
        self.nparams = jax.tree_util.tree_map(np.asarray, jparams)
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        jbatches = [{"tokens": jax.random.randint(keys[2 * i], (B, S), 0,
                                                  jcfg.vocab_size),
                     "labels": jax.random.randint(keys[2 * i + 1], (B, S),
                                                  0, jcfg.vocab_size)}
                    for i in range(2)]
        self.batches = [{k: torch.tensor(np.asarray(v)) for k, v in
                         b.items()} for b in jbatches]
        step = jax.jit(j_trainer.make_train_step(
            jcfg, jconfig.TrainConfig(**KW)))
        jp, jo, _ = step(jparams, j_opt.adamw_init(jparams), jbatches[0])
        jp, _, jm = step(jp, jo, jbatches[1])
        self.ref_loss = float(jm["loss"])
        self.ref_params = lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp))

    def fresh(self) -> tuple:
        params = lm_params_from_numpy(self.nparams)
        return params, t_opt.adamw_init(params)

    def shardings(self, shape, policy) -> tuple:
        mesh = _mesh(shape)
        with mesh_context(mesh, **shd.policy_kw(policy)):
            return make_shardings(self.cfg, self.tcfg, mesh)

    def step(self, state, i, shape=None, policy="tp") -> tuple:
        """Step ``i`` (0 or 1) from ``state``: ``(params, opt, loss)``."""
        run = make_train_step(self.cfg, self.tcfg)
        batch = self.batches[i]
        if shape is None:
            p, o, m = run(*state, batch)
            return p, o, float(m["loss"])
        mesh = tree.leaves(state)[0].mesh
        with mesh_context(mesh, **shd.policy_kw(policy)):
            b_sh = tree.tree_map(lambda x: shd.named_sharding(
                x.shape, ("batch",) + (None,) * (x.dim() - 1)), batch)
            p, o, m = run(*state, spmd.device_put(batch, b_sh))
        return p, o, float(m["loss"])

    def sharded(self, state, shape, policy):
        return spmd.device_put(state, self.shardings(shape, policy))


@pytest.fixture(scope="module")
def case():
    return Case()


# the states to save, after step 1: name -> (mesh shape or None, policy)
SOURCES = {"tp": ((2, 2), "tp"), "dp_only": ((2, 2), "dp_only"),
           "one": (None, "tp")}


@pytest.fixture(scope="module")
def saved(case, tmp_path_factory):
    """``{source: (file, the state's leaves gathered at save time, the
    step-2 params, optimizer state and loss from the in-memory state)}``:
    each source's step 1, its checkpoint, then the uninterrupted step 2
    (which updates the optimizer state in place)."""
    out = {}
    for name, (shape, policy) in SOURCES.items():
        state = case.fresh()
        if shape is not None:
            state = case.sharded(state, shape, policy)
        state = case.step(state, 0, shape, policy)[:2]
        assert all(isinstance(x, spmd.ShardedTensor) == (shape is not None)
                   for x in tree.leaves(state))
        path = ckpt.save_checkpoint(str(tmp_path_factory.mktemp(name)), 1,
                                    state)
        gathered = [_global(x).clone() for x in tree.leaves(state)]
        out[name] = path, gathered, case.step(state, 1, shape, policy)
    return out


def _global(x) -> torch.Tensor:
    return spmd.gather(x, "cpu") if isinstance(x, spmd.ShardedTensor) else x


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("source", ["tp", "dp_only"])
def test_a_sharded_save_is_the_global_state(case, saved, source):
    """The file holds each leaf of the sharded state gathered, bit for bit,
    dense on the host, and the fingerprint of the single-device state (the
    file a single-device run writes)."""
    path, gathered, _ = saved[source]
    payload = _load(path)
    assert payload["step"] == 1
    assert payload["fingerprint"] == ckpt.fingerprint(case.fresh())
    assert payload["fingerprint"] == _load(saved["one"][0])["fingerprint"]
    assert len(payload["leaves"]) == len(gathered)
    for got, want in zip(payload["leaves"], gathered):
        assert got.device.type == "cpu" and got.is_contiguous()
        assert got.dtype == want.dtype and torch.equal(got, want)


# (source, target mesh shape or None, target policy)
RESUMES = [("tp", (2, 2), "tp"), ("tp", (4, 1), "tp"), ("tp", None, "tp"),
           ("dp_only", (2, 2), "dp_only"), ("dp_only", (2, 2), "tp"),
           ("one", (2, 2), "tp")]


@pytest.mark.parametrize("source,shape,policy", RESUMES, ids=[
    "tp-same", "tp-to-4x1", "tp-to-one", "dp_only-same", "dp_only-to-tp",
    "one-to-2x2"])
def test_restore_and_resume(case, saved, source, shape, policy):
    """Restore onto ``shape`` under ``policy`` (``make_shardings`` of the
    new mesh; one device: ``shardings=None`` with a plain ``like``): every
    shard is its slice of the saved tensor bit for bit; the resumed step
    matches the reference's two uninterrupted steps, and on the mesh the
    state was saved from, the uninterrupted step bit for bit."""
    path, _, (p2, o2, loss2) = saved[source]
    like = case.fresh()
    if shape is None:
        step, state = ckpt.restore_checkpoint(path, like)
    else:
        step, state = ckpt.restore_checkpoint(
            path, like, case.shardings(shape, policy))
    assert step == 1
    for x, want in zip(tree.leaves(state), _load(path)["leaves"]):
        if shape is None:
            assert not isinstance(x, spmd.ShardedTensor)
            assert torch.equal(x, want)
            continue
        assert x.reads is None and x.mesh.shape == dict(
            zip(("data", "model"), shape))
        for pos in np.ndindex(x.shards.shape):
            assert torch.equal(x.shards[pos], want[x.index(pos)]), pos
    p, o, loss = case.step(state, 1, shape, policy)
    np.testing.assert_allclose(loss, case.ref_loss, **LOSS_TOL)
    for (where, got), want in zip(tree.flatten(p),
                                  tree.leaves(case.ref_params)):
        np.testing.assert_allclose(_global(got).numpy(), want.numpy(),
                                   err_msg=str(where), **PARAM_TOL)
    if (shape, policy) == SOURCES[source]:
        assert loss == loss2
        for got, want in zip(tree.leaves((p, o)), tree.leaves((p2, o2))):
            assert torch.equal(_global(got), _global(want))


def test_a_mismatched_tree_raises(case, saved):
    path = saved["tp"][0]
    params, opt = case.fresh()
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore_checkpoint(path, (params, opt._replace(step=None)))
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore_checkpoint(path, (params, opt._replace(
            step=torch.zeros((), dtype=torch.int64))))
    p_sh, o_sh = case.shardings((2, 2), "tp")
    with pytest.raises(ValueError, match="shardings has"):
        ckpt.restore_checkpoint(path, (params, opt), (p_sh, o_sh.m))


def test_without_shardings_a_leaf_follows_like(case, saved):
    """Without ``shardings`` each leaf is laid out as ``like``'s leaf: a
    ShardedTensor by its sharding (here the (4, 1) layout of a sharded
    ``like``), a tensor on its device."""
    path, gathered, _ = saved["tp"]
    like = case.sharded(case.fresh(), (4, 1), "tp")
    _, state = ckpt.restore_checkpoint(path, like)
    for x, l, want in zip(tree.leaves(state), tree.leaves(like), gathered):
        assert x.sharding == l.sharding
        assert torch.equal(spmd.gather(x, "cpu"), want)
    _, state = ckpt.restore_checkpoint(path, (like[0], case.fresh()[1]))
    assert all(isinstance(x, spmd.ShardedTensor) for x in tree.leaves(
        state[0]))
    assert not any(isinstance(x, spmd.ShardedTensor) for x in tree.leaves(
        state[1]))
