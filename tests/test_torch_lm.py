"""The port's language-model serving path against the JAX package.

hymba-1.5b-smoke (2 layers, d_model 64, 5/1 attention heads of 16,
window 32, SSD heads of 16, state 8, chunk 16) in float32, with the
reference's own initial weights carried across (``lm_params_from_numpy``).
The JAX functions run jitted; with ``use_kernel=True`` the reference runs
its Pallas kernels in interpret mode and the port its kernels' plain
versions (CPU tensors).  Tolerances: 2e-4 (relative and absolute) on
logits and activations, for float32 sums taken in another order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.config import get_config, list_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "hymba-1.5b-smoke"
MAX_LEN = 80


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    return jcfg, tcfg, jparams, tparams


def _tokens(seed, B, L, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


def test_configs_match_reference():
    for name in ("hymba-1.5b", ARCH):
        j, t = j_get_config(name), get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("padded_vocab", "hd", "ssm_inner", "ssm_heads",
                     "is_encoder", "is_moe"):
            assert getattr(j, prop) == getattr(t, prop)
        assert j.param_count() == t.param_count()
    assert {"hymba-1.5b", ARCH} <= set(list_configs())
    with pytest.raises(KeyError, match="unknown config"):
        get_config("no-such-model")


def test_init_matches_reference_tree(model):
    """Same names, shapes and dtypes as the reference's init; normal
    weights at 1/sqrt(fan_in), ones and zeros where the spec says."""
    jcfg, tcfg, jparams, _ = model
    tparams = t_tf.init(tcfg, torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: a, tparams))[0])
    assert len(jflat) == len(tflat)
    for path, a in jflat:
        t = tflat[path]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
    emb = tparams["embed"]                      # fan_in = d_model
    assert abs(float(emb.std()) * tcfg.d_model ** 0.5 - 1) < 0.05
    assert bool((tparams["layers"]["ssm"]["A_log"] == 1).all())
    assert bool((tparams["layers"]["ssm"]["dt_bias"] == 0).all())
    bf = t_tf.init(dataclasses.replace(tcfg, dtype="bfloat16"),
                   torch.Generator().manual_seed(0))
    assert bf["embed"].dtype == torch.bfloat16


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_layers.rms_norm(torch.as_tensor(x), torch.as_tensor(w))),
        np.asarray(j_attn.rms_norm(x, w)), **TOL)
    pos = np.arange(12, dtype=np.float32)
    jc, js = j_attn.rope_freqs(jnp.asarray(pos), 16, 10_000.0)
    tc, ts = t_layers.rope_freqs(torch.as_tensor(pos), 16, 10_000.0)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(t_layers.apply_rope(torch.as_tensor(x), tc[:, None],
                                ts[:, None])),
        np.asarray(j_attn.apply_rope(x, jc[:, None], js[:, None])), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_forward_matches_reference(model, use_kernel):
    jcfg, tcfg, jparams, tparams = model
    x = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(
        np.float32)
    pos = np.arange(64, dtype=np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    want = jax.jit(functools.partial(
        j_attn.attention_forward, cfg=jcfg, use_kernel=use_kernel,
        interpret=True))(jp, x, positions=pos)
    got = t_attn.attention_forward(
        t_layers.layer_slice(tparams["layers"], 0)["attn"],
        torch.as_tensor(x), tcfg, torch.as_tensor(pos),
        use_kernel=use_kernel)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches_reference(model, use_kernel):
    jcfg, tcfg, jparams, tparams = model
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(
        np.float32)                       # 40 % 16 != 0: the padding path
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["ssm"])
    want = jax.jit(functools.partial(
        j_ssm.ssm_forward, cfg=jcfg, use_kernel=use_kernel,
        interpret=True))(jp, x)
    got = t_ssm.ssm_forward(t_layers.layer_slice(tparams["layers"], 1)["ssm"],
                            torch.as_tensor(x), tcfg, use_kernel=use_kernel)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_layer_forward_matches_reference(model, use_kernel):
    """One whole hybrid layer (norms, both mixers, gated MLP) over the
    sequence, without caches."""
    jcfg, tcfg, jparams, tparams = model
    x = np.random.default_rng(8).standard_normal((2, 64, 64)).astype(
        np.float32)
    pos = np.arange(64, dtype=np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    want = jax.jit(lambda p, x, pos: j_tf._layer_forward(
        p, x, jcfg, pos, use_kernel, True, False))(jp, x, pos)
    got = t_tf._layer_forward(t_layers.layer_slice(tparams["layers"], 0),
                              torch.as_tensor(x), tcfg, torch.as_tensor(pos),
                              use_kernel)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _assert_caches_close(tc, jc):
    for name in ("attn", "ssm"):
        for field, a, b in zip(getattr(tc, name)._fields, getattr(tc, name),
                               getattr(jc, name)):
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       err_msg=f"{name}.{field}", **TOL)


@functools.lru_cache(maxsize=None)
def _j_prefill(cfg, use_kernel):
    return jax.jit(lambda p, t: j_tf.prefill(
        p, {"tokens": t}, cfg, MAX_LEN, use_kernel=use_kernel,
        interpret=True))


@functools.lru_cache(maxsize=None)
def _j_decode(cfg):
    return jax.jit(lambda p, t, c: j_tf.decode_step(p, t, c, cfg))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(model, use_kernel):
    """Prompt of 64 = twice the window: the sliding window and the rolling
    cache are exercised.  Logits and every cache field after prefill, then
    after one decode step on the caches each side produced."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(3, 2, 64, jcfg.vocab_size)
    jlogits, jcaches = _j_prefill(jcfg, use_kernel)(jparams, toks)
    fa0, ssd0 = fa_kernel.launch_count(), ssd_kernel.launch_count()
    tlogits, tcaches = t_tf.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                    tcfg, MAX_LEN, use_kernel=use_kernel)
    assert (fa_kernel.launch_count(), ssd_kernel.launch_count()) == (fa0,
                                                                     ssd0)
    assert tuple(tlogits.shape) == jlogits.shape == (2, 1, 128)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **TOL)
    _assert_caches_close(tcaches, jcaches)
    assert tcaches.attn.pos.dtype == torch.int32
    nxt = _tokens(4, 1, 2, jcfg.vocab_size)[0]
    jl, jcaches = _j_decode(jcfg)(jparams, nxt, jcaches)
    tl, tcaches = t_tf.decode_step(tparams, torch.as_tensor(nxt), tcaches,
                                   tcfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_caches_close(tcaches, jcaches)


def test_rolling_cache_quirk_matches_reference(model):
    """L % W != 0: prefill keeps the last W keys in slots 0..W-1 while
    decode writes position pos to slot pos % W, so the first decode steps
    overwrite keys that are not the oldest.  The port pins that quirk of
    the reference over several steps."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(5, 2, 40, jcfg.vocab_size)       # 40 % 32 == 8
    jlogits, jcaches = _j_prefill(jcfg, False)(jparams, toks)
    tlogits, tcaches = t_tf.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                    tcfg, MAX_LEN)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **TOL)
    cur = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
    for _ in range(4):
        jl, jcaches = _j_decode(jcfg)(jparams, cur, jcaches)
        tl, tcaches = t_tf.decode_step(tparams, torch.as_tensor(cur),
                                       tcaches, tcfg)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    _assert_caches_close(tcaches, jcaches)


_LENS = (12, 7, 20, 16, 9, 5)
_NEW = (4, 6, 3, 5, 2, 4)


def _requests(cls, vocab):
    rng = np.random.default_rng(6)
    return [cls(prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(_LENS, _NEW)]


def test_serve_engine_matches_reference(model):
    """6 requests at batch 4 (two waves), unequal prompts (left padding):
    the port's engine with ``use_kernel=False`` generates the reference
    engine's tokens."""
    jcfg, tcfg, jparams, tparams = model
    want = JServeEngine(jcfg, jparams, batch=4, max_len=MAX_LEN).generate(
        _requests(JRequest, jcfg.vocab_size))
    got = ServeEngine(tcfg, tparams, batch=4, max_len=MAX_LEN,
                      device="cpu", use_kernel=False).generate(
        _requests(Request, tcfg.vocab_size))
    assert len(got) == len(want) == 6
    for g, w, m in zip(got, want, _NEW):
        assert g.out.shape == (m,)
        np.testing.assert_array_equal(g.out, w.out)


def test_serve_engine_kernel_path_matches_reference(model):
    """``use_kernel=True`` against the reference's kernel prefill (Pallas
    in interpret mode) followed by its greedy decode loop, one wave."""
    jcfg, tcfg, jparams, tparams = model
    reqs = _requests(Request, tcfg.vocab_size)[:4]
    got = ServeEngine(tcfg, tparams, batch=4, max_len=MAX_LEN,
                      device="cpu").generate(reqs)
    T = max(_LENS[:4])
    toks = np.zeros((4, T), np.int32)
    for i, r in enumerate(reqs):
        toks[i, T - len(r.prompt):] = r.prompt
    logits, caches = _j_prefill(jcfg, True)(jparams, toks)
    cur = np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)
    want = [cur]
    for _ in range(max(_NEW[:4]) - 1):
        logits, caches = _j_decode(jcfg)(jparams, cur, caches)
        cur = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
        want.append(cur)
    want = np.stack(want, axis=1)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.out, want[i, :_NEW[i]])


def test_lm_params_from_numpy_roundtrips_bf16():
    cfg = j_get_config(ARCH)                         # bfloat16 weights
    jparams = j_tf.init(cfg, jax.random.PRNGKey(1))
    tree = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    for (path, a), t in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree_util.tree_leaves(tree)):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))
    f32 = lm_params_from_numpy({"w": np.asarray(jparams["embed"])},
                               dtype=torch.float32)
    assert f32["w"].dtype == torch.float32


def test_serve_engine_needs_a_card_unless_cpu_is_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg, _, tparams = model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main([])
    assert ServeEngine(tcfg, tparams, device="cpu").device.type == "cpu"


def test_serve_cli_on_cpu(capsys):
    t_serve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "10",
                  "--new-tokens", "3", "--batch", "2", "--max-len", "16"])
    out = capsys.readouterr().out
    assert "[serve] arch=hymba-1.5b-smoke 3 requests, 9 tokens" in out


def test_unported_parts_raise(model):
    """What neither package serves raises: the engine prefills from token
    prompts only (an embeddings-input model is refused, where the
    reference's engine fails at its prefill), and ``chunked_mha`` needs
    lengths that its chunks divide.  The MoE layer and embeddings inputs
    are ported: ``tests/test_torch_moe.py`` and ``tests/test_torch_arch.py``
    hold them against the reference."""
    _, tcfg, _, tparams = model
    emb = dataclasses.replace(tcfg, input_mode="embeddings")
    with pytest.raises(ValueError, match="token prompts"):
        ServeEngine(emb, tparams, device="cpu")
    with pytest.raises(ValueError, match="chunked_mha"):
        t_attn.chunked_mha(torch.zeros(1, 5, 600, 16),
                           torch.zeros(1, 1, 600, 16),
                           torch.zeros(1, 1, 600, 16), causal=True,
                           window=None)
