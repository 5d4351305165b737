"""The port's mixture-of-experts layer and MoE models against the JAX
package.

granite-moe-3b-a800m-smoke (5 experts, top 2) and phi3.5-moe-smoke (4
experts, top 2), 2 layers at d_model 64, in float32, with the reference's
own initial weights carried across (``lm_params_from_numpy``).  The smoke
configs' capacity factor of 64 never drops; the dropping cases set it to 1.
The JAX functions run jitted; with ``use_kernel=True`` the reference runs
its Pallas kernels in interpret mode and the port its kernels' plain
versions (CPU tensors).  Tolerance: 2e-4 (relative, and absolute against
each leaf's largest magnitude), for float32 sums taken in another order.
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get_config
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.models.layers import init_params as j_init_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.train.data import LMDataPipeline as JLMDataPipeline
from repro_torch import tree
from repro_torch.config import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(1)

TOL = 2e-4
GRANITE, PHI = "granite-moe-3b-a800m-smoke", "phi3.5-moe-42b-a6.6b-smoke"
SEQ = 32
MAX_LEN = 48


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


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _cfgs(name, **kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config(name), **kw),
            dataclasses.replace(get_config(name), **kw))


@functools.lru_cache(maxsize=None)
def _model(name):
    jcfg, tcfg = _cfgs(name)
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def _port_grads(loss_fn, params):
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves))
    return loss, torch.autograd.grad(loss, leaves)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# (tokens, experts, top-k, capacity factor) -> slots per expert, by the
# reference's formula (repro/models/moe.py: floored at k, ceiled at T * k,
# rounded up to a multiple of 128 above 128)
CAPACITIES = [
    ((16384, 40, 8, 1.25), 4096),     # granite's prefill wave: 8 x 2048
    ((1024, 5, 2, 1.0), 512),         # 409 rounded up to 512
    ((128, 5, 2, 1.0), 51),           # below 128: not rounded
    ((8, 40, 8, 1.25), 8),            # a decode batch: floored at k
    ((2, 16, 2, 1.25), 2),            # ... and ceiled at T * k
    ((4096, 16, 2, 1.25), 640),       # phi3.5 at 2 x 2048
    ((64, 5, 2, 64.0), 128),          # the smoke configs: never drops
]


@pytest.mark.parametrize("case,cap", CAPACITIES)
def test_capacity_is_the_reference_formula(case, cap):
    T, E, K, cf = case
    cfg = dataclasses.replace(get_config(GRANITE), moe_experts=E,
                              moe_topk=K, moe_capacity_factor=cf)
    assert t_moe.capacity(T, cfg) == cap


# (config, batch, sequence, config overrides, slots per expert, whether
# assignments drop): no drops on both smoke configs (capacity factor 64);
# drops (128 tokens at factor 1: cap 51); the capacity rounded up to 512
# (1024 tokens: 409 -> 512); granite's routing (40 experts, top 8) at a
# decode batch of 8, which never drops (cap = k = 8 >= T); and a decode
# batch above k, which can (cap = k = 2 < T = 4): the reference's "tiny
# decode batches must never drop" holds only while T <= k, and the port
# keeps its formula (ROADMAP.md, queue 3)
GRANITE_ROUTING = {"moe_experts": 40, "moe_topk": 8,
                   "moe_capacity_factor": 1.25}
LAYER_CASES = {
    "granite": (GRANITE, 2, 32, {}, 128, False),
    "phi": (PHI, 2, 32, {}, 128, False),
    "drops": (GRANITE, 2, 64, {"moe_capacity_factor": 1.0}, 51, True),
    "rounded": (GRANITE, 4, 256, {"moe_capacity_factor": 1.0}, 512, False),
    "decode": (GRANITE, 8, 1, GRANITE_ROUTING, 8, False),
    "decode-above-k": (GRANITE, 4, 1, {"moe_capacity_factor": 1.0}, 2,
                       True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES.values()),
                         ids=list(LAYER_CASES))
def test_moe_layer_matches_reference(case):
    """``moe_forward`` and ``moe_aux_loss`` against the reference, and the
    gradients of a random projection of both with respect to the inputs
    and every expert and router weight (``jax.grad``): gradients reach
    the router through the gates and the aux loss, and the inputs through
    the scatter and the gather."""
    name, B, S, kw, cap, drops = case
    jcfg, tcfg = _cfgs(name, **kw)
    jp = j_init_params(jax.random.PRNGKey(1), j_moe.moe_spec(jcfg),
                       jnp.float32)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)

    def j_obj(p, x):
        return (jnp.sum(j_moe.moe_forward(p, x, jcfg) * w)
                + j_moe.moe_aux_loss(p, x, jcfg))

    want_y = jax.jit(lambda p, x: j_moe.moe_forward(p, x, jcfg))(jp, x)
    want_aux = jax.jit(lambda p, x: j_moe.moe_aux_loss(p, x, jcfg))(jp, x)
    want_gp, want_gx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(jp, x)

    leaves = [t.requires_grad_() for t in tree.leaves(tp)]
    tx = torch.tensor(x, requires_grad=True)
    tpar = tree.unflatten(tp, leaves)
    y = t_moe.moe_forward(tpar, tx, tcfg)
    aux = t_moe.moe_aux_loss(tpar, tx, tcfg)
    _close(y, want_y)
    _close(aux, want_aux)
    grads = torch.autograd.grad((y * torch.tensor(w)).sum() + aux,
                                leaves + [tx])
    for got, want in zip(grads, _jleaves(want_gp) + [want_gx]):
        _close(got, want)

    r = t_moe.route(tpar, tx.detach().reshape(-1, tcfg.d_model), tcfg)
    assert r.cap == cap
    assert bool((~r.keep).any()) == drops


def _jleaves(t):
    return jax.tree_util.tree_leaves(t)


def test_moe_layer_bf16_sums_over_k_like_the_reference():
    """In bfloat16 the weighted sum over the top k accumulates in float32
    and rounds once, as the reference's ``jnp.sum`` does: granite's routing
    (top 8 of 40, capacity factor 1.25, so some assignments drop) agrees
    with the reference to one bfloat16 ulp, where a chain of bfloat16 adds
    rounds seven times.  The inputs make every step before the sum exact
    and equal in both packages: the router reads distinct multiples of 1/8
    (no top-k ties), and the gate projection is about 16, where SiLU is the
    identity in bfloat16 however it is evaluated."""
    jcfg, tcfg = _cfgs(GRANITE, dtype="bfloat16", **GRANITE_ROUTING)
    D, F_, E = tcfg.d_model, tcfg.d_ff, tcfg.moe_experts
    B, S = 2, 64
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x[..., :E] = (np.argsort(rng.random((B, S, E)), axis=-1) - 20) / 8
    x[..., D - 1] = 1.0
    router = np.zeros((D, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0
    wg = 0.02 * rng.standard_normal((E, D, F_)).astype(np.float32)
    wg[:, D - 1] = 16.0
    p = {"router": router, "wg": wg,
         "wu": 0.1 * rng.standard_normal((E, D, F_)).astype(np.float32),
         "wd": 0.1 * rng.standard_normal((E, F_, D)).astype(np.float32)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.tensor(v).bfloat16() for k, v in p.items()}
    # op by op: under jit the CPU compiler may keep fused intermediates in
    # float32 (excess precision), which is not the rounding the code states
    want = np.asarray(j_moe.moe_forward(
        jp, jnp.asarray(x, jnp.bfloat16), jcfg).astype(jnp.float32))
    xt = torch.tensor(x).bfloat16()
    y = t_moe.moe_forward(tp, xt, tcfg)
    assert y.dtype == torch.bfloat16
    assert bool((~t_moe.route(tp, xt.reshape(-1, D), tcfg).keep).any())
    got = y.float().numpy()
    # one bfloat16 ulp of each reference value (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_routing_ranks_earlier_tokens_first():
    """Within an expert, assignments are ranked in token order; past the
    capacity the later ones drop and their slot is cap - 1."""
    cfg = dataclasses.replace(get_config(GRANITE), dtype="float32",
                              moe_experts=2, moe_topk=1,
                              moe_capacity_factor=1.0)
    router = torch.tensor([[1.0, -1.0]] + [[0.0, 0.0]] * 63)
    xt = torch.zeros(6, 64)
    xt[:, 0] = torch.tensor([1.0, 2.0, -1.0, 3.0, 4.0, -2.0])
    r = t_moe.route({"router": router}, xt, cfg)
    assert r.cap == 3
    assert r.idx[:, 0].tolist() == [0, 0, 1, 0, 0, 1]
    assert r.keep.tolist() == [True, True, True, True, False, True]
    assert r.slot.tolist() == [0, 1, 0, 2, 2, 1]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _batch(cfg, step=0, B=2):
    jb = JLMDataPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=B, period=16).batch_at(step)
    nb = {k: np.asarray(v) for k, v in jb.items()}
    return nb, {k: torch.tensor(v) for k, v in nb.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", [GRANITE, PHI])
def test_train_loss_with_aux_and_gradients_match_reference(name, use_kernel):
    """``train_loss`` (the aux term of the first layer's router on the
    embedded input included) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, jparams, tparams = _model(name)
    nb, tb = _batch(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.train_loss(p, nb, jcfg, use_kernel=use_kernel,
                                  interpret=True)))(jparams)
    loss, grads = _port_grads(lambda p: t_tf.train_loss(
        p, tb, tcfg, use_kernel=use_kernel), tparams)
    _close(loss, jloss)
    assert len(grads) == len(_jleaves(jgrads))
    for (path, _), got, want in zip(tree.flatten(tparams), grads,
                                    _jleaves(jgrads)):
        _close(got, want)
        if path[-1] == "router":
            assert float(got.abs().max()) > 0
    x = t_tf._embed_in(tparams, tb, tcfg)
    aux = t_moe.moe_aux_loss({"router": tparams["layers"]["moe"]["router"][0]},
                             x, tcfg)
    bare = t_tf.train_loss(tparams, tb, tcfg, moe_aux_weight=0.0)
    _close(bare + 0.01 * aux, loss)


def test_remat_variants_recompute_the_same_routing():
    """Remat off, per layer, grouped (nested) and grouped alone on a
    4-layer MoE model with drops: bit-identical gradients, so each
    checkpointed recompute routed the tokens as the forward did."""
    base = dataclasses.replace(get_config(GRANITE), dtype="float32",
                               num_layers=4, moe_capacity_factor=1.0)
    params = t_tf.init(base, torch.Generator().manual_seed(0))
    _, batch = _batch(base, B=4)
    grads = {}
    for remat, group in ((False, 0), (True, 0), (True, 2), (False, 2)):
        cfg = dataclasses.replace(base, remat=remat, remat_group=group)
        _, grads[remat, group] = _port_grads(
            lambda p: t_tf.train_loss(p, batch, cfg), params)
    for g in grads.values():
        assert all(torch.equal(a, b) for a, b in zip(g, grads[False, 0]))


def _assert_caches_close(tc, jc):
    for field, a, b in zip(tc.attn._fields, tc.attn, jc.attn):
        _close(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", [GRANITE, PHI])
def test_prefill_and_decode_match_reference(name, use_kernel):
    """Prefill logits and caches, then three greedy decode steps on the
    caches each side produced."""
    jcfg, tcfg, jparams, tparams = _model(name)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t: j_tf.prefill(
        p, {"tokens": t}, jcfg, MAX_LEN, use_kernel=use_kernel,
        interpret=True))(jparams, toks)
    tlogits, tcaches = t_tf.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                    tcfg, MAX_LEN, use_kernel=use_kernel)
    _close(tlogits, jlogits)
    _assert_caches_close(tcaches, jcaches)
    j_decode = jax.jit(lambda p, t, c: j_tf.decode_step(p, t, c, jcfg))
    cur = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
    for _ in range(3):
        jl, jcaches = j_decode(jparams, cur, jcaches)
        tl, tcaches = t_tf.decode_step(tparams, torch.as_tensor(cur),
                                       tcaches, tcfg)
        _close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    _assert_caches_close(tcaches, jcaches)


def test_serve_engine_matches_reference():
    """granite-smoke: 5 requests of unequal prompts at batch 4 (two waves,
    left padding); the port's plain-path engine generates the reference
    engine's tokens."""
    jcfg, tcfg, jparams, tparams = _model(GRANITE)
    rng = np.random.default_rng(6)
    lens, new = (12, 7, 20, 16, 9), (4, 6, 3, 5, 2)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    want = JServeEngine(jcfg, jparams, batch=4, max_len=MAX_LEN).generate(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    got = ServeEngine(tcfg, tparams, batch=4, max_len=MAX_LEN, device="cpu",
                      use_kernel=False).generate(
        [Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    for g, w, m in zip(got, want, new):
        assert g.out.shape == (m,)
        np.testing.assert_array_equal(g.out, w.out)
