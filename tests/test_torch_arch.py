"""Every architecture of the model zoo in the port against the JAX package.

The ten ``ARCHS`` on their smoke configs (2 layers, d_model 64) in
float32, with the reference's own initial weights carried across
(``lm_params_from_numpy``) and the reference pipeline's batches (frame or
patch embeddings for the embeddings-input models).  The JAX functions run
jitted; with ``use_kernel=True`` the reference runs its Pallas kernels in
interpret mode and the port its kernels' plain versions (CPU tensors).
Tolerance: 2e-4 (relative, and absolute against each leaf's largest
magnitude), for float32 sums taken in another order.
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs import ARCHS as J_ARCHS
from repro.models import transformer as j_tf
from repro.train.data import LMDataPipeline as JLMDataPipeline
from repro_torch import config as tconfig
from repro_torch import tree
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf
from repro_torch.train.trainer import value_and_grad

torch.set_num_threads(1)

TOL = 2e-4
SEQ = 32
MAX_LEN = 48
DECODERS = [a for a in ARCHS if not tconfig.get_config(a).is_encoder]
TOKEN_DECODERS = [a for a in DECODERS
                  if tconfig.get_config(a).input_mode == "tokens"]


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


@functools.lru_cache(maxsize=None)
def _model(arch):
    name = arch + "-smoke"
    jcfg = dataclasses.replace(jconfig.get_config(name), dtype="float32")
    tcfg = dataclasses.replace(tconfig.get_config(name), dtype="float32")
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def _batch(cfg, B=2):
    """The reference pipeline's batch (with embeddings for the
    embeddings-input models), as numpy and as CPU tensors."""
    embed = cfg.d_model if cfg.input_mode == "embeddings" else 0
    jb = JLMDataPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=B, period=16,
                         embed_dim=embed).batch_at(0)
    nb = {k: np.asarray(v) for k, v in jb.items()}
    return nb, {k: torch.tensor(v) for k, v in nb.items()}


def test_archs_are_the_reference_archs():
    assert ARCHS == J_ARCHS
    assert set(tconfig.list_configs()) >= {
        n for a in ARCHS for n in (a, a + "-smoke")}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for name in (arch, arch + "-smoke"):
        j, t = jconfig.get_config(name), tconfig.get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("padded_vocab", "hd", "ssm_inner", "ssm_heads",
                     "is_encoder", "is_moe"):
            assert getattr(j, prop) == getattr(t, prop), (name, prop)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
        if t.is_moe:
            assert t.active_param_count() < t.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """Same names, shapes and dtypes as the reference's parameter tree."""
    _, tcfg, jparams, _ = _model(arch)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = tree.flatten(t_tf.init(tcfg, torch.Generator().manual_seed(0)))
    assert len(got) == len(want)
    for (jpath, shape), (tpath, t) in zip(want, got):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(t.shape) == tuple(shape.shape), tpath
        assert t.dtype == torch.float32


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch, use_kernel):
    jcfg, tcfg, jparams, tparams = _model(arch)
    nb, tb = _batch(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.train_loss(p, nb, jcfg, use_kernel=use_kernel,
                                  interpret=True)))(jparams)
    # llava's token table is unused by the embeddings-input loss: its
    # gradient is zero, as under jax.grad
    loss, grads = value_and_grad(functools.partial(
        t_tf.train_loss, cfg=tcfg, use_kernel=use_kernel), tparams, tb)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    _close(loss, jloss)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jl)
    for got, want in zip(grads, jl):
        _close(got, want)


def _assert_caches_close(tc, jc):
    for name in ("attn", "ssm"):
        if getattr(tc, name) is None:
            assert getattr(jc, name) is None
            continue
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            _close(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch, use_kernel):
    """Prefill (from embeddings for llava, as the reference prefills it)
    then two greedy decode steps on the caches each side produced."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    nb, tb = _batch(tcfg)
    key = "embeddings" if tcfg.input_mode == "embeddings" else "tokens"
    jlogits, jcaches = jax.jit(lambda p, b: j_tf.prefill(
        p, b, jcfg, MAX_LEN, use_kernel=use_kernel, interpret=True))(
        jparams, {key: nb[key]})
    tlogits, tcaches = t_tf.prefill(tparams, {key: tb[key]}, tcfg, MAX_LEN,
                                    use_kernel=use_kernel)
    _close(tlogits, jlogits)
    _assert_caches_close(tcaches, jcaches)
    j_decode = jax.jit(lambda p, t, c: j_tf.decode_step(p, t, c, jcfg))
    cur = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
    for _ in range(2):
        jl, jcaches = j_decode(jparams, cur, jcaches)
        tl, tcaches = t_tf.decode_step(tparams, torch.as_tensor(cur),
                                       tcaches, tcfg)
        _close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    _assert_caches_close(tcaches, jcaches)


@pytest.mark.parametrize("arch", TOKEN_DECODERS)
def test_prefill_then_decode_matches_longer_prefill(arch):
    """The port's own consistency: decoding token T after a T-token
    prefill gives the last logits of a (T + 1)-token prefill (the
    reference's ``tests/test_arch_smoke.py`` check; embeddings-input
    models decode tokens and are left out, as there)."""
    _, tcfg, _, tparams = _model(arch)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 17)))
    _, caches = t_tf.prefill(tparams, {"tokens": toks[:, :16]}, tcfg, 64)
    logits, _ = t_tf.decode_step(tparams, toks[:, 16], caches, tcfg)
    full, _ = t_tf.prefill(tparams, {"tokens": toks}, tcfg, 64)
    np.testing.assert_allclose(_np(logits), _np(full[:, 0]), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-370m", "h2o-danube-1.8b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_cli_on_cpu_for_other_archs(arch, capsys):
    t_serve.main(["--arch", arch + "-smoke", "--device", "cpu",
                  "--requests", "3", "--prompt-len", "10", "--new-tokens",
                  "3", "--batch", "2", "--max-len", "16"])
    out = capsys.readouterr().out
    assert f"[serve] arch={tconfig.get_config(arch + '-smoke').name} " \
           f"3 requests, 9 tokens" in out


@pytest.mark.parametrize("arch,error", [("hubert-xlarge", SystemExit),
                                        ("llava-next-34b", ValueError)])
def test_serve_cli_refuses_embeddings_inputs(arch, error):
    """The CLI refuses an encoder itself, as the reference's does; an
    embeddings-input decoder is refused by the ServeEngine."""
    with pytest.raises(error):
        t_serve.main(["--arch", arch + "-smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b",
                                  "granite-moe-3b-a800m"])
def test_train_cli_on_cpu_for_other_archs(arch, tmp_path, capsys):
    t_train.main(["--arch", arch + "-smoke", "--device", "cpu", "--steps",
                  "2", "--seq", "16", "--batch", "2", "--log-every", "1",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[trainer] step 2 loss=" in out


# ---------------------------------------------------------------------------
# the layout knobs: ssm_fused_proj=False and kv_replicate
# ---------------------------------------------------------------------------

def test_ssm_split_proj_variant():
    """``tests/test_arch_smoke.py::test_ssm_split_proj_variant``: mamba2
    with per-stream projections (``ssm_fused_proj=False``) trains to a
    finite loss, and a decode step after a 16-token prefill gives the
    17-token prefill's logits (2e-3); the loss and both logits are also
    the reference's on its own weights (``TOL``)."""
    B = 2
    jcfg = dataclasses.replace(jconfig.get_config("mamba2-370m-smoke"),
                               ssm_fused_proj=False, dtype="float32")
    cfg = dataclasses.replace(tconfig.get_config("mamba2-370m-smoke"),
                              ssm_fused_proj=False, dtype="float32")
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    assert "w_x" in params["layers"]["ssm"]
    assert "w_in" not in params["layers"]["ssm"]
    jtoks = jax.random.randint(jax.random.PRNGKey(3), (B, 17), 0,
                               jcfg.vocab_size)
    toks = torch.tensor(np.asarray(jtoks))
    loss = t_tf.train_loss(params, {"tokens": toks[:, :-1],
                                    "labels": toks[:, 1:]}, cfg)
    assert bool(torch.isfinite(loss))
    jloss = j_tf.train_loss(jparams, {"tokens": jtoks[:, :-1],
                                      "labels": jtoks[:, 1:]}, jcfg)
    _close(loss, jloss)
    pre, caches = t_tf.prefill(params, {"tokens": toks[:, :16]}, cfg,
                               max_len=64)
    dec, _ = t_tf.decode_step(params, toks[:, 16], caches, cfg)
    full, _ = t_tf.prefill(params, {"tokens": toks}, cfg, max_len=64)
    np.testing.assert_allclose(_np(dec), _np(full[:, 0]), rtol=2e-3,
                               atol=2e-3)
    jfull, _ = j_tf.prefill(jparams, {"tokens": jtoks}, jcfg, max_len=64)
    _close(full, jfull)
    _close(pre, j_tf.prefill(jparams, {"tokens": jtoks[:, :16]}, jcfg,
                             max_len=64)[0])


def test_kv_replicate_is_exact():
    """``tests/test_beyond_paper.py::test_kv_replicate_is_exact``:
    ``kv_replicate`` changes the sharding metadata (``wk``/``wv``'s
    ``head`` axis left unnamed), never the math: qwen3's loss with and
    without it agrees to 1e-7, and with the reference's loss."""
    jcfg = dataclasses.replace(jconfig.get_config("qwen3-4b-smoke"),
                               dtype="float32")
    cfg = dataclasses.replace(tconfig.get_config("qwen3-4b-smoke"),
                              dtype="float32")
    cfg_r = dataclasses.replace(cfg, kv_replicate=True)
    assert t_tf.axes(cfg_r)["layers"]["attn"]["wk"][-1] is None
    assert t_tf.axes(cfg)["layers"]["attn"]["wk"][-1] == "head"
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    jtoks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                               jcfg.vocab_size)
    toks = torch.tensor(np.asarray(jtoks))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    a = t_tf.train_loss(params, batch, cfg)
    b = t_tf.train_loss(params, batch, cfg_r)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-7)
    want = j_tf.train_loss(jparams, {"tokens": jtoks[:, :-1],
                                     "labels": jtoks[:, 1:]},
                           dataclasses.replace(jcfg, kv_replicate=True))
    _close(b, want)
