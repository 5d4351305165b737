"""The port's LM training path against the JAX package.

hymba-1.5b-smoke (2 layers, d_model 64) in float32 with the reference's
own initial weights carried across (``lm_params_from_numpy``) and the
reference's batches fed to both packages (the random bits of the two
pipelines differ).  The JAX functions run jitted; with ``use_kernel=True``
the reference runs its Pallas kernels in interpret mode and the port its
kernels' plain versions (CPU tensors) under the autograd Functions.

Tolerances, for float32 sums taken in another order: 2e-4 (relative, and
absolute against each leaf's largest magnitude) on losses, gradients,
optimizer states and parameters; 2e-5 on attention outputs and gradients
(the reference kernel tests' float32 bound); the SSD gradients 1e-4
normwise, since the reference differentiates its sequential scan and the
port the chunked form (ROADMAP.md, queue 3).
"""
import dataclasses
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.kernels.flash_attention.ops import (
    attention_trainable as j_attention_trainable,
)
from repro.kernels.ssd.ops import ssd_trainable as j_ssd_trainable
from repro.launch import steps as j_steps
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro.train import trainer as j_trainer
from repro.train.data import LMDataPipeline as JLMDataPipeline
from repro_torch import config as tconfig
from repro_torch import tree
from repro_torch.configs.wiener_velocity import WienerVelocityConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import simulate_linear
from repro_torch.kernels.flash_attention import attention_trainable
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd_trainable
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as t_tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train.data import LMDataPipeline, TrajectoryDataPipeline
from repro_torch.train.trainer import Trainer, make_train_step

torch.set_num_threads(1)

TOL = 2e-4
ARCH = "hymba-1.5b-smoke"
SEQ = 64


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


def _jleaves(t):
    return jax.tree_util.tree_leaves(t)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfig.get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfig.get_config(ARCH), dtype="float32")
    jparams = j_tf.init(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    return jcfg, tcfg, jparams, tparams


def _batch(step=0, batch=2, vocab=128):
    """The reference pipeline's batch, as numpy and as CPU tensors."""
    jb = JLMDataPipeline(vocab_size=vocab, seq_len=SEQ, global_batch=batch,
                         period=16).batch_at(step)
    nb = {k: np.asarray(v) for k, v in jb.items()}
    return nb, {k: torch.tensor(v) for k, v in nb.items()}


def _port_grads(loss_fn, params):
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves))
    return loss, torch.autograd.grad(loss, leaves)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

def test_config_classes_match_reference():
    for cls in ("ModelConfig", "ShapeConfig", "TrainConfig", "MeshConfig"):
        fields = [[(f.name, f.default) for f in dataclasses.fields(
            getattr(mod, cls))] for mod in (jconfig, tconfig)]
        assert fields[0] == fields[1], cls
    assert ([dataclasses.asdict(s) for s in jconfig.SHAPE_SUITE]
            == [dataclasses.asdict(s) for s in tconfig.SHAPE_SUITE])
    assert [s.tokens for s in tconfig.SHAPE_SUITE] == [
        s.tokens for s in jconfig.SHAPE_SUITE]
    assert tconfig.MeshConfig(2, 4, 3).num_devices == 24
    reasons = 0
    for name in jconfig.list_configs():
        jc = jconfig.get_config(name)
        tc = tconfig.ModelConfig(**dataclasses.asdict(jc))
        for js, ts in zip(jconfig.SHAPE_SUITE, tconfig.SHAPE_SUITE):
            want = jconfig.shape_skip_reason(jc, js)
            assert tconfig.shape_skip_reason(tc, ts) == want, (name, js)
            reasons += want is not None
    assert reasons > 0


def _jpath(path):
    out = []
    for k in path:
        out.append(getattr(k, "key", getattr(k, "name", getattr(k, "idx",
                                                                None))))
    return tuple(out)


def test_input_specs_match_reference():
    jcfg, tcfg = jconfig.get_config("hymba-1.5b"), tconfig.get_config(
        "hymba-1.5b")
    for jshape, tshape in zip(jconfig.SHAPE_SUITE, tconfig.SHAPE_SUITE):
        want = [(_jpath(p), tuple(x.shape), str(x.dtype)) for p, x in
                jax.tree_util.tree_flatten_with_path(
                    j_steps.input_specs(jcfg, jshape))[0]]
        specs = t_steps.input_specs(tcfg, tshape)
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in tree.flatten(specs)]
        assert got == want, jshape.name
        assert all(x.device.type == "meta" for x in tree.leaves(specs))
    fn, specs = t_steps.make_step(tcfg, tconfig.SHAPE_SUITE[0],
                                  tconfig.TrainConfig())
    assert callable(fn) and set(specs) == {"params", "opt", "batch"}


# ---------------------------------------------------------------------------
# the trainable kernel ops
# ---------------------------------------------------------------------------

FA_CASES = [  # B, Hq, Hkv, L, D, causal, window
    (2, 4, 2, 64, 16, True, None),
    (1, 5, 1, 128, 16, True, 32),
    (2, 2, 2, 32, 8, False, None),
]


@pytest.mark.parametrize("case", FA_CASES)
def test_attention_trainable_matches_reference_vjp(case):
    B, Hq, Hkv, L, D, causal, window = case
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D),
                   (B, Hq, L, D)))
    out, vjp = jax.vjp(lambda q, k, v: j_attention_trainable(
        q, k, v, causal, window, True), q, k, v)
    want = vjp(g)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = attention_trainable(*ts, causal, window)
    got = torch.autograd.grad(o, ts, torch.tensor(g))
    _close(o, out, 2e-5)
    for a, b in zip(got, want):
        _close(a, b, 2e-5)


SSD_CASES = [  # b, L, H, P, G, S, chunk
    (2, 64, 4, 8, 1, 8, 16),
    (1, 48, 4, 8, 2, 4, 32),      # L not a multiple of the chunk
]


def _ssd_inputs(case, seed=2):
    b, L, H, P, G, S, _ = case
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, L, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(f)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(f)
    Bm, Cm = (rng.standard_normal((b, L, G, S)).astype(f) for _ in range(2))
    D = rng.standard_normal(H).astype(f)
    g = rng.standard_normal((b, L, H, P)).astype(f)
    return (x, dt, A, Bm, Cm, D), g


def _normwise(got, want, tol):
    got, want = _np(got), _np(want)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_trainable_matches_reference_vjp(case):
    ins, g = _ssd_inputs(case)
    chunk = case[-1]
    out, vjp = jax.vjp(lambda *a: j_ssd_trainable(*a, chunk, True), *ins)
    want = vjp(g)
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    y = ssd_trainable(*ts, chunk)
    got = torch.autograd.grad(y, ts, torch.tensor(g))
    _close(y, out)
    for a, b in zip(got, want):
        _normwise(a, b, 1e-4)
    # bfloat16 storage with a float32 A: each gradient in its input's dtype
    tb = [torch.tensor(a).to(torch.float32 if i == 2 else torch.bfloat16)
          .requires_grad_() for i, a in enumerate(ins)]
    grads = torch.autograd.grad(ssd_trainable(*tb, chunk).float().sum(), tb)
    assert [x.dtype for x in grads] == [x.dtype for x in tb]
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_ssd_backward_is_finite_where_the_reference_plain_gradient_is_not():
    """Decays of dt·A = -2 over a chunk of 64 overflow exp above the
    diagonal: the reference's ``ssd_scan_jnp`` gradient is nan there (its
    ``where`` after ``exp``); the port masks before ``exp``, and its
    gradient matches the reference's ``ssd_trainable`` (the sequential
    ``ssd_ref``)."""
    (x, _, _, Bm, Cm, D), g = _ssd_inputs((1, 128, 2, 4, 1, 4, 64))
    dt = np.full((1, 128, 2), 2.0, np.float32)
    A = np.full((2,), -1.0, np.float32)
    ins = (x, dt, A, Bm, Cm, D)
    plain = jax.grad(lambda *a: jnp.sum(j_ssm.ssd_scan_jnp(*a, 64) * g),
                     argnums=(1, 2))(*ins)
    assert not all(np.isfinite(np.asarray(p)).all() for p in plain)
    _, vjp = jax.vjp(lambda *a: j_ssd_trainable(*a, 64, True), *ins)
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    got = torch.autograd.grad(ssd_trainable(*ts, 64), ts, torch.tensor(g))
    for a, b in zip(got, vjp(g)):
        assert bool(torch.isfinite(a).all())
        _normwise(a, b, 1e-4)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_loss_and_gradients_match_reference(model, use_kernel):
    jcfg, tcfg, jparams, tparams = model
    nb, tb = _batch()
    mask = (np.random.default_rng(3).random(nb["tokens"].shape) > 0.2
            ).astype(np.float32)
    for extra in ({}, {"loss_mask": mask}):
        jb = {**nb, **extra}
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: j_tf.train_loss(p, jb, jcfg, use_kernel=use_kernel,
                                      interpret=True)))(jparams)
        batch = {**tb, **{k: torch.tensor(v) for k, v in extra.items()}}
        loss, grads = _port_grads(lambda p: t_tf.train_loss(
            p, batch, tcfg, use_kernel=use_kernel), tparams)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        _close(loss, jloss)
        assert len(grads) == len(_jleaves(jgrads))
        for got, want in zip(grads, _jleaves(jgrads)):
            _close(got, want)


def test_remat_variants_give_the_same_gradients_and_forward_counts(
        monkeypatch):
    """Remat off, per layer, grouped, grouped alone, and grouped with the
    layers unrolled (no group checkpoint, as in the reference):
    bit-identical gradients on the CPU, and each kernel op's forward runs
    as often as ``chip_smoke.py``'s launch gate counts: L without remat, 2L
    with one level, 3L - L/g with both."""
    calls = {"attention": 0, "ssd": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(fa_ops, "attention")
    counting(ssd_ops, "ssd")
    base = dataclasses.replace(tconfig.get_config(ARCH), dtype="float32",
                               num_layers=4)
    params = t_tf.init(base, torch.Generator().manual_seed(0))
    _, batch = _batch()
    grads = {}
    forwards = {(False, 0, False): 4, (True, 0, False): 8,
                (True, 2, False): 10, (False, 2, False): 8,
                (True, 2, True): 8}
    for (remat, group, unroll), n in forwards.items():
        cfg = dataclasses.replace(base, remat=remat, remat_group=group,
                                  unroll_layers=unroll)
        calls.update(attention=0, ssd=0)
        _, grads[remat, group, unroll] = _port_grads(
            lambda p: t_tf.train_loss(p, batch, cfg, use_kernel=True),
            params)
        assert calls == {"attention": n, "ssd": n}, (remat, group, unroll)
    for g in grads.values():
        assert all(torch.equal(a, b)
                   for a, b in zip(g, grads[False, 0, False]))


# ---------------------------------------------------------------------------
# the optimizer and the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.05, 0.0])
def test_adamw_matches_reference(clip):
    """Three steps on a two-leaf tree (float32 and bfloat16 params), with
    the clip active (global norms ~10 > 0.05) and off."""
    rng = np.random.default_rng(4)
    tcfg_kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                   grad_clip=clip)
    jt, tt = jconfig.TrainConfig(**tcfg_kw), tconfig.TrainConfig(**tcfg_kw)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    jp = {"a": jnp.asarray(p0["a"]), "b": jnp.asarray(p0["b"])}
    tp = {k: torch.as_tensor(v) for k, v in p0.items()}
    jstate, tstate = j_opt.adamw_init(jp), t_opt.adamw_init(tp)
    jsched, tsched = j_opt.cosine_schedule(jt), t_opt.cosine_schedule(tt)
    for step in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {"a": torch.as_tensor(g["a"]),
              "b": torch.as_tensor(g["b"]).to(torch.bfloat16)}
        jg["b"] = jg["b"].astype(jnp.bfloat16)
        _close(t_opt.global_norm(tg), j_opt.global_norm(jg))
        jp, jstate, jstats = j_opt.adamw_update(jg, jstate, jt, jsched,
                                                jnp.float32)
        before = tstate
        tp, tstate, tstats = t_opt.adamw_update(tg, tstate, tt, tsched,
                                                torch.float32)
        # m, v and master are updated in place; the params are new tensors
        assert all(a is b for a, b in zip(tree.leaves(before[1:]),
                                          tree.leaves(tstate[1:])))
        assert not any(a is b for a, b in zip(tree.leaves(tp),
                                              tree.leaves(tstate.master)))
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert tstate.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            _close(tstats[k], jstats[k])
        for got, want in zip(tree.leaves((tp, tstate.m, tstate.v,
                                          tstate.master)),
                             _jleaves((jp, jstate.m, jstate.v,
                                       jstate.master))):
            _close(got, want)
    for s in range(8):
        _close(tsched(s), jsched(s))
        _close(tsched(torch.tensor(s, dtype=torch.int32)), jsched(s))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(model, microbatches):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4,
              global_batch=4, seq_len=SEQ, microbatches=microbatches)
    jstep = jax.jit(j_trainer.make_train_step(jcfg, jconfig.TrainConfig(
        **kw)))
    tstep = make_train_step(tcfg, tconfig.TrainConfig(**kw))
    jp, jo = jparams, j_opt.adamw_init(jparams)
    tp, to = tparams, t_opt.adamw_init(tparams)
    for step in range(2):
        nb, tb = _batch(step, batch=4)
        jp, jo, jm = jstep(jp, jo, nb)
        tp, to, tm = tstep(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], jm[k])
    assert int(to.step) == int(jo.step) == 2
    for got, want in zip(tree.leaves((tp, to.m, to.v, to.master)),
                         _jleaves((jp, jo.m, jo.v, jo.master))):
        _close(got, want)


def test_zero1_logical_rewrite():
    assert t_opt.zero1_logical(("embed", "ff"), (512, 1024), 16) == (
        "zero1", "ff")
    assert t_opt.zero1_logical(("embed",), (7,), 16) == ("embed",)
    assert t_opt.zero1_logical(("vocab", "embed"), (50304, 512), 16) == (
        "vocab", "zero1")
    for axes, shape, n in ((("embed", "ff"), (512, 1024), 16),
                           ((None, "heads"), (8, 6), 4),
                           (("vocab", None), (30, 2), 4)):
        assert t_opt.zero1_logical(axes, shape, n) == j_opt.zero1_logical(
            axes, shape, n)


def test_cosine_schedule_shape():
    lr = t_opt.cosine_schedule(tconfig.TrainConfig(
        learning_rate=1e-3, warmup_steps=10, total_steps=100))
    assert float(lr(0)) < float(lr(9))
    np.testing.assert_allclose(float(lr(10)), 1e-3, rtol=0.2)
    assert float(lr(99)) < 1e-4
    assert lr(3).dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoints, data, trainer, entry point
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path):
    cfg = tconfig.get_config(ARCH)
    params = t_tf.init(cfg, torch.Generator().manual_seed(0))
    opt = t_opt.adamw_init(params)
    assert params["embed"].dtype == torch.bfloat16
    path = ckpt.save_checkpoint(str(tmp_path), 7, (params, opt))
    assert os.path.exists(path)
    step, (p2, o2) = ckpt.restore_checkpoint(path, (params, opt))
    assert step == 7 and isinstance(o2, t_opt.AdamWState)
    for a, b in zip(tree.leaves((params, opt)), tree.leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_and_pruning(tmp_path):
    t = {"w": torch.arange(8.0)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, t)
    ckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000000003.ckpt", "step_000000000004.ckpt"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("4.ckpt")
    # a stray temporary file is never picked up
    open(os.path.join(tmp_path, "garbage.tmp"), "w").write("x")
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("4.ckpt")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_tree_guard(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    for like in ({"b": torch.zeros(3)}, {"a": torch.zeros(4)},
                 {"a": torch.zeros(3, dtype=torch.bfloat16)}):
        with pytest.raises(ValueError, match="mismatch"):
            ckpt.restore_checkpoint(path, like)


def test_data_pipeline_deterministic_and_learnable():
    pipe = LMDataPipeline(vocab_size=64, seq_len=128, global_batch=4,
                          seed=3, period=16, corruption=0.1)
    a, b, c = pipe.batch_at(5), pipe.batch_at(5), pipe.batch_at(6)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], dataclasses.replace(
        pipe, seed=4).batch_at(5)["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 128)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # periodic structure: token t mostly equals token t - period (0.81 in
    # expectation at 10 % corruption), over eight batches
    toks = torch.cat([pipe.batch_at(s)["tokens"] for s in range(5, 13)])
    agree = (toks[:, 16:] == toks[:, :-16]).double().mean().item()
    assert agree > 0.75, agree
    emb = dataclasses.replace(pipe, embed_dim=8).batch_at(5)
    assert emb["embeddings"].shape == (4, 128, 8)


def test_trajectory_pipeline_is_a_seeded_simulation():
    model = WienerVelocityConfig().model()
    ts = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    pipe = TrajectoryDataPipeline(model=model, ts=ts, batch=3, seed=1)
    a = pipe.batch_at(2)
    assert a["x_true"].shape == (3, 11, model.nx)
    assert a["y"].shape == (3, 10, model.ny)
    assert torch.equal(a["y"], pipe.batch_at(2)["y"])
    assert not torch.equal(a["y"], pipe.batch_at(3)["y"])
    g = torch.Generator().manual_seed(int(np.random.SeedSequence(
        [1, 2]).generate_state(1)[0]))
    xs, ys = simulate_linear(model, ts[:, None].expand(-1, 3), g)
    assert torch.equal(a["y"], ys.movedim(1, 0))


def test_trainer_runs_resumes_and_learns(tmp_path):
    cfg = tconfig.get_config(ARCH)
    tcfg = tconfig.TrainConfig(
        learning_rate=3e-3, total_steps=30, warmup_steps=3,
        checkpoint_every=10, keep_checkpoints=2, log_every=1,
        seq_len=SEQ, global_batch=4)
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                          global_batch=4, seed=0, period=16)
    logs, seen = [], {}

    def on_step(step, m):
        seen[step] = float(m["loss"])

    tr = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipe, ckpt_dir=str(tmp_path),
                 log_fn=logs.append, device="cpu", on_step=on_step)
    params, opt, metrics = tr.run(steps=12)
    assert int(opt.step) == 12 and tr.start_step == 0
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000000010.ckpt", "step_000000000012.ckpt"]
    assert [(n, os.path.basename(path)) for n, path, _ in tr.saves] == [
        (10, "step_000000000010.ckpt"), (12, "step_000000000012.ckpt")]
    assert all(sec >= 0 for _, _, sec in tr.saves)

    # resume: a new trainer picks up from the newest checkpoint
    tr2 = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipe, ckpt_dir=str(tmp_path),
                  log_fn=logs.append, device="cpu", on_step=on_step)
    params2, opt2, metrics2 = tr2.run(steps=30)
    assert int(opt2.step) == 30 and tr2.start_step == 12
    assert [n for n, _, _ in tr2.saves] == [20, 30]
    assert any("resumed" in str(m) and "@ 12" in str(m) for m in logs)
    losses = [float(m.split("loss=")[1].split()[0]) for m in logs
              if "loss=" in m]
    assert len(losses) == 30 and losses[-1] == pytest.approx(
        float(metrics2["loss"]), abs=1e-4)
    assert sorted(seen) == list(range(1, 31))
    assert losses == pytest.approx([seen[n] for n in range(1, 31)],
                                   abs=1e-4)
    # descent: a batch of 4 x 64 tokens is noisy, so compare the mean of
    # the last six steps with that of the first six, and stay near the
    # uniform floor
    first, last = np.mean(losses[:6]), np.mean(losses[-6:])
    assert last < first - 0.05, (first, last)
    assert last < np.log(cfg.vocab_size) * 1.15


def test_trainer_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tconfig.get_config(ARCH)
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                          global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg=cfg, tcfg=tconfig.TrainConfig(), pipeline=pipe,
                ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--ckpt-dir", str(tmp_path)])
    assert Trainer(cfg=cfg, tcfg=tconfig.TrainConfig(), pipeline=pipe,
                   ckpt_dir=str(tmp_path), device="cpu").device.type == "cpu"


def test_train_cli_on_cpu(tmp_path, capsys):
    params, opt, metrics = t_train.main([
        "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
        "--microbatches", "2", "--log-every", "1", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] arch=hymba-1.5b-smoke" in out and "device=cpu" in out
    assert "[trainer] step 3 loss=" in out
    assert int(opt.step) == 3 and bool(torch.isfinite(metrics["loss"]))
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("3.ckpt")
