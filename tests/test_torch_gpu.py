"""Tests of the port that need a CUDA card: the LM kernels on the card
(also under autograd, and a training step through them; attention at head
size 80), the MoE layer and an MoE model's gradients,
the whole-scan ``lqt_scan`` kernel against its plain scan, the pairwise
kernel as ``scan_combine_fn``, a sharded checkpoint restored across mesh
shapes on a repeated card, and the
nonlinear estimation paths (the iterated Taylor and sigma-point
smoothers), the estimation serving engines (``TrajectoryEngine``,
``StreamingEngine``) and the record-axis split over a mesh through it.

They skip without a card.  This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` configures JAX).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
from repro_torch.core import (
    Estimator,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    Problem,
    SigmaPointOptions,
    simulate_nonlinear,
    time_grid,
)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.lqt_combine import kernel as lqt_kernel
from repro_torch.kernels.lqt_combine import ref as lqt_ref
from repro_torch.kernels.lqt_combine import scan as lqt_scan
from repro_torch.core.types import LQTElement
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import transformer
from repro_torch.serving import Request, ServeEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(card):
    """Each LM kernel against its plain version on the card, at the
    reference tests' tolerances (``chip_smoke.py`` covers more shapes)."""
    g = card
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((2, 4, 128, 64), (2, 2, 128, 64),
                             (2, 2, 128, 64)))
        before = fa_kernel.launch_count()
        got = fa_kernel.flash_attention(q, k, v, causal=True, window=48)
        assert fa_kernel.launch_count() == before + 1
        want = tfa.mha_ref(q, k, v, causal=True, window=48)
        assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        l = -torch.rand(8, 512, generator=g, device="cuda") * 0.2
        dtx, Bm, Cm = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((8, 512, 64), (8, 512, 16), (8, 512, 16)))
        got = ssd_kernel.ssd_chunked(l, dtx, Bm, Cm, chunk=256)
        want = tssd.ssd_chunked_ref(l, dtx, Bm, Cm, chunk=256)
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= (
            2e-5 if dtype == torch.float32 else 0.04) * scale


@pytest.mark.gpu
def test_serve_kernel_path_matches_plain_path_on_card(card):
    """hymba-1.5b-smoke in float32 on the card: the engine generates the
    same tokens through the kernels as through the plain chunked paths,
    and the kernel path launches each kernel once per layer and wave."""
    cfg = dataclasses.replace(get_config("hymba-1.5b-smoke"),
                              dtype="float32")
    params = transformer.init(cfg, card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (64, 40, 17, 64, 5)]
    outs = {}
    for use_kernel in (True, False):
        fa_kernel.reset_launch_count()
        ssd_kernel.reset_launch_count()
        done = ServeEngine(cfg, params, batch=4, max_len=80,
                           use_kernel=use_kernel).generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])
        outs[use_kernel] = np.stack([r.out for r in done])
        want = 2 * cfg.num_layers if use_kernel else 0     # two waves
        assert fa_kernel.launch_count() == ssd_kernel.launch_count() == want
    np.testing.assert_array_equal(outs[True], outs[False])


def _normwise_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainable_ops_on_card_match_autograd_through_plain(card, dtype):
    """``attention_trainable`` and ``ssd_trainable`` on the card: the
    forward is one kernel launch within the kernel's tolerance of the plain
    version, and the gradients are autograd through the plain versions
    (``mha_ref``; ``ssd_scan_chunked``) on the same inputs."""
    g = card
    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def leaves(*shapes):
        return [torch.randn(s, generator=g, device="cuda").to(dtype)
                .requires_grad_() for s in shapes]

    q, k, v = leaves((2, 4, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64))
    before = fa_kernel.launch_count()
    o = tfa.attention_trainable(q, k, v, True, 96)
    assert fa_kernel.launch_count() == before + 1
    go = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
    got = torch.autograd.grad(o, (q, k, v), go)
    ref = tfa.mha_ref(q, k, v, causal=True, window=96)
    want = torch.autograd.grad(ref, (q, k, v), go)
    assert fa_kernel.launch_count() == before + 1
    assert torch.allclose(o.float(), ref.float(),
                          rtol=2e-5 if dtype == torch.float32 else 2e-2,
                          atol=2e-5 if dtype == torch.float32 else 2e-2)
    for a, b in zip(got, want):
        assert a.dtype == dtype and _normwise_err(a, b) <= tol

    b_, L, H, P, G, S = 2, 512, 8, 64, 1, 16
    x, Bm, Cm = leaves((b_, L, H, P), (b_, L, G, S), (b_, L, G, S))
    dt = torch.nn.functional.softplus(torch.randn(
        (b_, L, H), generator=g, device="cuda")).to(dtype).requires_grad_()
    A = (-torch.rand(H, generator=g, device="cuda") - 0.5).requires_grad_()
    D = torch.randn(H, generator=g, device="cuda").to(dtype)
    D.requires_grad_()
    ins = (x, dt, A, Bm, Cm, D)
    before = ssd_kernel.launch_count()
    y = tssd.ssd_trainable(*ins, 256)
    assert ssd_kernel.launch_count() == before + 1
    gy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
    got = torch.autograd.grad(y, ins, gy)
    ref = tssd.ssd_scan_chunked(*ins, 256)
    want = torch.autograd.grad(ref, ins, gy)
    assert ssd_kernel.launch_count() == before + 1
    assert _normwise_err(y, ref) <= (2e-5 if dtype == torch.float32
                                     else 0.04)
    for a, b, t in zip(got, want, ins):
        assert a.dtype == t.dtype and _normwise_err(a, b) <= tol


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """hymba-1.5b-smoke in float32: two steps of two microbatches through
    the kernels on the card against the plain path on the CPU, from the
    same weights and batches; each kernel launches once per forward of a
    layer (remat recomputes included); then a ``Trainer`` on the card
    trains, checkpoints and resumes."""
    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.train import Trainer, adamw_init, make_train_step
    from repro_torch.train.data import LMDataPipeline

    cfg = dataclasses.replace(get_config("hymba-1.5b-smoke"),
                              dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                       global_batch=4, seq_len=64, microbatches=2,
                       checkpoint_every=2, log_every=1)
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=4)
    cpu = transformer.init(cfg, torch.Generator().manual_seed(0))
    gpu = tree.tree_map(lambda t: t.cuda(), cpu)
    kernel_step = make_train_step(cfg, tcfg, lambda p, b: transformer.
                                  train_loss(p, b, cfg, use_kernel=True))
    plain_step = make_train_step(cfg, tcfg)
    states = {"cuda": (gpu, adamw_init(gpu)), "cpu": (cpu, adamw_init(cpu))}
    layer_forward, forwards = transformer._layer_forward, [0]

    def counting(*a, **k):
        forwards[0] += 1
        return layer_forward(*a, **k)

    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    for step in range(2):
        batch = pipe.batch_at(step)
        monkeypatch.setattr(transformer, "_layer_forward", counting)
        states["cuda"] = kernel_step(*states["cuda"][:2], tree.tree_map(
            lambda t: t.cuda(), batch))
        monkeypatch.setattr(transformer, "_layer_forward", layer_forward)
        states["cpu"] = plain_step(*states["cpu"][:2], batch)
    assert forwards[0] >= 2 * tcfg.microbatches * cfg.num_layers
    assert (fa_kernel.launch_count() == ssd_kernel.launch_count()
            == forwards[0])
    for k in ("loss", "grad_norm"):
        assert abs(float(states["cuda"][2][k]) - float(states["cpu"][2][k])
                   ) <= 1e-4 * abs(float(states["cpu"][2][k]))
    for a, b in zip(tree.leaves(states["cuda"][:2]),
                    tree.leaves(states["cpu"][:2])):
        assert _normwise_err(a.cpu(), b) <= 1e-4

    logs = []
    run = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipe, ckpt_dir=str(tmp_path),
                  log_fn=logs.append).run(steps=2)
    assert run[0]["embed"].device.type == "cuda" and int(run[1].step) == 2
    _, opt, metrics = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipe,
                              ckpt_dir=str(tmp_path),
                              log_fn=logs.append).run(steps=4)
    assert int(opt.step) == 4 and bool(torch.isfinite(metrics["loss"]))
    assert any("resumed" in m for m in logs)


# (B, Hq, Hkv, Lq, Lk, D, window): each head size of the tensor-core
# kernel; decode alignment (Lq < Lk); Lq, Lk off the 64-row tiles; windows
# off the tiles.
FA_MMA_CASES = [
    (2, 4, 2, 128, 128, 16, None),
    (1, 6, 2, 96, 160, 32, 40),
    (1, 4, 1, 1, 300, 64, None),
    (2, 8, 2, 100, 300, 128, 70),
    (1, 25, 5, 200, 200, 64, 100),
    (1, 4, 2, 100, 300, 80, None),
    (2, 8, 2, 64, 200, 80, 70),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FA_MMA_CASES)
def test_flash_attention_mma_matches_plain_on_card(card, case):
    B, Hq, Hkv, Lq, Lk, D, window = case
    q, k, v = (torch.randn(s, generator=card, device="cuda").bfloat16()
               for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    before = fa_kernel.launch_count("mma")
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    assert fa_kernel.launch_count("mma") == before + 1
    want = tfa.mha_ref(q, k, v, causal=True, window=window)
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# (B, Hq, Hkv, Lq, Lk, causal, window) at head size 80 (hubert-xlarge,
# h2o-danube-1.8b): hubert's non-causal MHA, danube's GQA with a window,
# and Lq < Lk off the 64-row tiles
FA_D80_CASES = [
    (2, 4, 4, 130, 130, False, None),
    (1, 8, 2, 200, 200, True, 96),
    (1, 4, 2, 70, 300, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_D80_CASES)
def test_flash_attention_head_dim_80_on_card(card, case, dtype):
    """D = 80 runs the tensor-core kernel in bfloat16 and the float32
    kernel in float32, each within its tolerance of ``mha_ref``."""
    B, Hq, Hkv, Lq, Lk, causal, window = case
    q, k, v = (torch.randn(s, generator=card, device="cuda").to(dtype)
               for s in ((B, Hq, Lq, 80), (B, Hkv, Lk, 80), (B, Hkv, Lk, 80)))
    which = fa_kernel.variant(dtype, 80)
    assert which == ("mma" if dtype == torch.bfloat16 else "simt")
    before = fa_kernel.launch_count(which)
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.launch_count(which) == before + 1
    want = tfa.mha_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_dispatch_on_card(card):
    """bf16 with D >= 16 runs the tensor-core kernel; float32 and D = 8 run
    the float32 kernel; the per-variant counts add up to the total."""
    fa_kernel.reset_launch_count()
    for dtype, D, which in ((torch.bfloat16, 64, "mma"),
                            (torch.bfloat16, 16, "mma"),
                            (torch.bfloat16, 8, "simt"),
                            (torch.float32, 64, "simt")):
        assert fa_kernel.variant(dtype, D) == which
        q, k, v = (torch.randn(s, generator=card, device="cuda").to(dtype)
                   for s in ((1, 2, 64, D), (1, 1, 64, D), (1, 1, 64, D)))
        before = fa_kernel.launch_count(which)
        fa_kernel.flash_attention(q, k, v, causal=True)
        assert fa_kernel.launch_count(which) == before + 1
    assert fa_kernel.launch_count("mma") == 2
    assert fa_kernel.launch_count("simt") == 2
    assert fa_kernel.launch_count() == 4


# (BH, L, P, S, chunk): S in {8, 64, 128}, P in {16, 128}, chunks of 64,
# 100 (off the 16-row tiles) and 256.
SSD_MMA_CASES = [
    (4, 512, 16, 8, 256),
    (3, 300, 128, 64, 100),
    (2, 256, 128, 128, 64),
    (5, 200, 16, 128, 100),
    (8, 512, 64, 16, 256),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_MMA_CASES)
def test_ssd_mma_matches_plain_on_card(card, case):
    """The three-stage kernel against the plain version (y, at the
    reference's bf16 rule) and against the staged plain version (the
    entering chunk states of stage 2, float32 to 1e-4 of their
    magnitude)."""
    BH, L, P, S, chunk = case
    l = -torch.rand(BH, L, generator=card, device="cuda") * 0.2
    dtx, Bm, Cm = (torch.randn(s, generator=card, device="cuda").bfloat16()
                   for s in ((BH, L, P), (BH, L, S), (BH, L, S)))
    before = ssd_kernel.launch_count("mma")
    got = ssd_kernel.ssd_chunked(l, dtx, Bm, Cm, chunk=chunk)
    assert ssd_kernel.launch_count("mma") == before + 1
    want = tssd.ssd_chunked_ref(l, dtx, Bm, Cm, chunk=chunk)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 0.04 * scale
    _, states, _ = ssd_kernel._run_mma(l, dtx, Bm, Cm, chunk)
    _, want_states = tssd.ssd_staged_ref(l, dtx, Bm, Cm, chunk=chunk)
    err = float((states - want_states).abs().max())
    assert err <= 1e-4 * max(float(want_states.abs().max()), 1e-30)


@pytest.mark.gpu
def test_ssd_dispatch_on_card(card):
    ssd_kernel.reset_launch_count()
    for dtype, which in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        assert ssd_kernel.variant(dtype, 64) == which
        l = -torch.rand(2, 128, generator=card, device="cuda") * 0.2
        dtx, Bm, Cm = (torch.randn(s, generator=card, device="cuda").to(dtype)
                       for s in ((2, 128, 64), (2, 128, 16), (2, 128, 16)))
        ssd_kernel.ssd_chunked(l, dtx, Bm, Cm, chunk=64)
    assert ssd_kernel.launch_count("mma") == ssd_kernel.launch_count("simt") == 1
    assert ssd_kernel.launch_count() == 2


@pytest.mark.gpu
def test_scan_kernel_matches_plain_scan_on_card(card):
    """One launch per scan, at every state size the kernel takes
    (1 <= nx <= 8), for one record and for (2, 3) records, both
    directions, n with an empty tree level (2), odd n and one element;
    normwise within 1e-9 of the plain scan in float64 and 1e-3 in float32
    (``chip_smoke.py`` covers the paths' sizes)."""
    for (dtype, tol), nx in itertools.product(
            ((torch.float64, 1e-9), (torch.float32, 1e-3)), range(1, 9)):
        for n, rec in ((1, ()), (2, (2, 3)), (17, ()), (65, (2, 3))):
            sh = (n,) + rec

            def r(*s):
                return torch.randn(*sh, *s, generator=card, device="cuda",
                                   dtype=torch.float64)

            def psd():
                A = r(nx, nx)
                return A @ A.transpose(-1, -2) / nx + 0.1 * torch.eye(
                    nx, device="cuda", dtype=torch.float64)

            e = LQTElement(*(x.to(dtype) for x in (
                r(nx, nx) * 0.6, r(nx), psd(), r(nx), psd())))
            for reverse in (False, True):
                before = lqt_scan.launch_count()
                got = lqt_scan.lqt_scan(e, reverse=reverse)
                want = lqt_ref.lqt_scan_ref(e, reverse=reverse)
                torch.cuda.synchronize()
                assert lqt_scan.launch_count() == before + 1
                scale = max(float(w.abs().max()) for w in want)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                assert err <= tol * scale, (dtype, nx, n, rec, reverse, err)


@pytest.mark.gpu
@pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")
def test_nonlinear_kernel_path_matches_plain_on_card(card):
    """The iterated smoother on the coordinated turn (N = 640, euler, 3
    passes, two records) through ``parallel_kernel`` launches the scan
    kernel ``lqt_scan`` at nx = 5 once per pass (the whole tree over 65
    elements in one launch; the pairwise ``lqt_combine`` not at all) and
    agrees with ``parallel_rts`` on the card to 1e-8 (``chip_smoke.py``
    runs the paper's full size).  The filter: torch's forward-mode AD loads
    its decompositions through ``torch.jit.script``, which some torch
    builds mark deprecated."""
    cfg = CoordinatedTurnConfig()
    model = cfg.model(device="cuda")
    ts = time_grid(cfg.t0, cfg.tf, 640, device="cuda")
    _, y = simulate_nonlinear(model, ts[:, None].expand(-1, 2), card)
    p = Problem.stacked(model, ts, y.movedim(1, 0))
    sols = {}
    for method, inner in (("parallel_kernel", KernelOptions(mode="euler")),
                          ("parallel_rts", ParallelOptions(mode="euler"))):
        before = lqt_scan.launch_count(), lqt_kernel.launch_count()
        sols[method] = Estimator(model, method=method, options=IteratedOptions(
            inner=inner, iterations=3)).solve(p)
        torch.cuda.synchronize()
        launched = lqt_scan.launch_count() - before[0]
        assert launched == (3 if method == "parallel_kernel" else 0)
        assert lqt_kernel.launch_count() == before[1]
    k, r = sols["parallel_kernel"], sols["parallel_rts"]
    assert k.x.device.type == "cuda" and bool(torch.isfinite(k.x).all())
    assert float((k.x - r.x).abs().max()) < 1e-8
    assert bool((k.cost_trace[:, -1] < k.cost_trace[:, 0]).all())


@pytest.mark.gpu
@pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")
def test_sigma_point_kernel_inner_matches_plain_on_card(card):
    """``method="sigma_point"`` (unscented SLR) on the coordinated turn
    (N = 640, euler, 3 passes, two records) with ``parallel_kernel`` as
    the inner method launches ``lqt_scan`` once per pass and agrees with
    the ``parallel_rts`` inner method on the card to 1e-8."""
    cfg = CoordinatedTurnConfig()
    model = cfg.model(device="cuda")
    ts = time_grid(cfg.t0, cfg.tf, 640, device="cuda")
    _, y = simulate_nonlinear(model, ts[:, None].expand(-1, 2), card)
    p = Problem.stacked(model, ts, y.movedim(1, 0))
    sols = {}
    for method, inner in (("parallel_kernel", KernelOptions(mode="euler")),
                          ("parallel_rts", ParallelOptions(mode="euler"))):
        before = lqt_scan.launch_count(), lqt_kernel.launch_count()
        sols[method] = Estimator(model, method="sigma_point",
                                 options=SigmaPointOptions(
                                     inner_method=method, inner=inner,
                                     iterations=3)).solve(p)
        torch.cuda.synchronize()
        launched = lqt_scan.launch_count() - before[0]
        assert launched == (3 if method == "parallel_kernel" else 0)
        assert lqt_kernel.launch_count() == before[1]
    k, r = sols["parallel_kernel"], sols["parallel_rts"]
    assert k.x.device.type == "cuda" and bool(torch.isfinite(k.x).all())
    assert bool(torch.isfinite(k.cost_trace).all())
    assert float((k.x - r.x).abs().max()) < 1e-8


def _wiener_records(lengths, g):
    """Wiener-velocity records of ``lengths`` intervals (dt = 0.1) from
    the port's simulator on the CPU, as numpy arrays."""
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import simulate_linear

    model = WienerVelocityConfig(p0=1.0).model()
    out = []
    for n in lengths:
        ts = time_grid(0.0, 0.1 * n, n)
        _, y = simulate_linear(model, ts, g)
        out.append((ts.numpy(), y.numpy()))
    return model, out


@pytest.mark.gpu
def test_trajectory_engine_kernel_on_card_matches_cpu(card):
    """A small ``TrajectoryEngine`` with ``parallel_kernel`` on the card:
    one ``lqt_scan`` launch per wave, no ``lqt_combine`` launch, and every
    record equal to the same engine on the CPU at 1e-9 x scale."""
    from repro_torch.serving import TrajectoryEngine

    model, recs = _wiener_records([37, 120, 55, 300, 41, 260, 90],
                                  torch.Generator().manual_seed(0))
    opts = KernelOptions(nsub=10, mode="discrete")
    sols = {}
    for device in ("cuda", "cpu"):
        eng = TrajectoryEngine(model, batch=4, method="parallel_kernel",
                               options=opts, device=device)
        before = lqt_scan.launch_count(), lqt_kernel.launch_count()
        sols[device] = eng.estimate(recs)
        torch.cuda.synchronize()
        if device == "cuda":
            assert lqt_scan.launch_count() - before[0] == eng.waves > 0
            assert lqt_kernel.launch_count() == before[1]
    for k, c in zip(sols["cuda"], sols["cpu"]):
        assert k.x.device.type == "cuda"
        scale = float(c.x.abs().max())
        assert float((k.x.cpu() - c.x).abs().max()) < 1e-9 * scale


@pytest.mark.gpu
def test_streaming_engine_kernel_on_card_matches_cpu(card):
    """Small ``StreamingEngine``s with ``parallel_kernel`` on the card (a
    linear one, and a sigma-point one with the kernel as its inner
    method): ``lqt_scan`` launches equal waves x passes, and the
    estimates equal the same engines on the CPU at 1e-9 x scale."""
    from repro_torch.serving import StreamingEngine
    from repro_torch.serving.waves import robust_default_options

    wiener, recs = _wiener_records([120] * 5,
                                   torch.Generator().manual_seed(1))
    cfg = CoordinatedTurnConfig()
    ct = cfg.model()
    ts = time_grid(0.0, 6.0, 60)
    _, y = simulate_nonlinear(ct, ts[:, None].expand(-1, 3),
                              torch.Generator().manual_seed(2))
    ct_recs = [(ts.numpy(), y[:, i].numpy()) for i in range(3)]
    sp = robust_default_options("sigma_point").replace(
        inner_method="parallel_kernel",
        inner=KernelOptions(nsub=10, mode="discrete"), iterations=3)
    cases = (
        (wiener, recs, dict(lag=30, batch=4, method="parallel_kernel",
                            options=KernelOptions(nsub=10,
                                                  mode="discrete")), 1, 20),
        (ct, ct_recs, dict(lag=20, batch=4, method="sigma_point",
                           options=sp), 3, 15))
    for model, data, kw, passes, chunk in cases:
        got = {}
        for device in ("cuda", "cpu"):
            eng = StreamingEngine(model, device=device, **kw)
            tids = [eng.open_track(float(ts_[0])) for ts_, _ in data]
            before = lqt_scan.launch_count(), lqt_kernel.launch_count()
            for i in range(0, data[0][1].shape[0], chunk):
                for tid, (ts_, y_) in zip(tids, data):
                    eng.push(tid, ts_[i + 1:i + 1 + chunk],
                             y_[i:i + chunk])
                eng.run()
            torch.cuda.synchronize()
            if device == "cuda":
                assert (lqt_scan.launch_count() - before[0]
                        == eng.waves * passes > 0)
                assert lqt_kernel.launch_count() == before[1]
            got[device] = [eng.estimate(t) for t in tids]
        for k, c in zip(got["cuda"], got["cpu"]):
            assert k.x.device.type == "cpu"      # host-built readers
            assert bool(torch.isfinite(k.x).all())
            scale = float(c.x.abs().max())
            assert float((k.x - c.x).abs().max()) < 1e-9 * scale


@pytest.mark.gpu
def test_batch_sharded_kernel_launches_once_per_shard_on_card(card):
    """Stacked records split over a batch axis of 4 (a mesh that repeats
    card 0): one ``lqt_scan`` launch per shard, the unsplit solve's result
    at 1e-9 x scale; and ``distributed`` on a 4 x 2 mesh of the card
    against ``parallel_rts`` at 1e-9."""
    from repro_torch.core import DistributedOptions, Problem
    from repro_torch.distributed import MeshSpec

    model, recs = _wiener_records([400] * 8, torch.Generator().manual_seed(3))
    ts = recs[0][0]
    ys = np.stack([y for _, y in recs])
    problem = Problem.stacked(model, ts, ys)
    opts = KernelOptions(nsub=10, mode="discrete")

    def mesh(time, batch):
        return MeshSpec(time=time, batch=batch).build(
            ["cuda:0"] * (time * batch))

    sharded = Estimator(model, method="parallel_kernel", options=opts,
                        mesh=mesh(1, 4))
    before = lqt_scan.launch_count(), lqt_kernel.launch_count()
    got = sharded.solve(problem)
    torch.cuda.synchronize()
    assert lqt_scan.launch_count() - before[0] == 4
    assert lqt_kernel.launch_count() == before[1]
    want = Estimator(model, method="parallel_kernel", options=opts).solve(
        problem)
    scale = float(want.x.abs().max())
    assert got.x.device.type == "cuda"
    assert float((got.x - want.x).abs().max()) < 1e-9 * scale
    dist = Estimator(model, method="distributed", mesh=mesh(4, 2),
                     options=DistributedOptions(nsub=10, mode="discrete"))
    ref = Estimator(model, options=ParallelOptions(nsub=10, mode="discrete"))
    assert torch.allclose(dist.solve(problem).x, ref.solve(problem).x,
                          rtol=1e-9, atol=1e-9)


@pytest.mark.gpu
def test_moe_forward_bf16_on_card_matches_cpu_float32(card):
    """granite-moe-3b-a800m-smoke's MoE layer (5 experts, top 2; its
    capacity factor of 64 drops nothing, so a token's output depends on
    its own routing alone) at 512 tokens: bfloat16 on the card against
    float32 on the CPU from the same bfloat16-rounded weights and inputs.
    bfloat16 router logits may reorder near-tied experts, so the outputs
    are compared on the tokens whose expert sets agree (at least 95 % of
    them), to 2e-2 of the output's magnitude."""
    from repro_torch.models import moe

    cfg = get_config("granite-moe-3b-a800m-smoke")
    spec = moe.moe_spec(cfg)
    g = torch.Generator().manual_seed(0)
    params = {k: (torch.randn(p.shape, generator=g) / p.shape[-2] ** 0.5)
              .bfloat16() for k, p in spec.items()}
    x = torch.randn(4, 128, cfg.d_model, generator=g).bfloat16()
    cpu32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    want = moe.moe_forward(p32, x.float(), cpu32)
    gpu = {k: v.cuda() for k, v in params.items()}
    got = moe.moe_forward(gpu, x.cuda(), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    T, E = 4 * 128, cfg.moe_experts
    r_cpu = moe.route(p32, x.float().reshape(T, -1), cpu32)
    r_gpu = moe.route(gpu, x.cuda().reshape(T, -1), cfg)
    assert r_gpu.cap == r_cpu.cap == moe.capacity(T, cfg)
    assert bool(r_gpu.keep.all()) and bool(r_cpu.keep.all())
    sets = [torch.zeros(T, E).scatter_(1, r.idx.cpu(), 1.0)
            for r in (r_cpu, r_gpu)]
    same = (sets[0] == sets[1]).all(dim=1)
    assert float(same.float().mean()) >= 0.95
    err = (got.float().cpu().reshape(T, -1)[same]
           - want.reshape(T, -1)[same]).abs().max()
    assert float(err) <= 2e-2 * float(want.abs().max())


@pytest.mark.gpu
def test_moe_train_loss_gradient_on_card_matches_cpu(card):
    """granite-moe-3b-a800m-smoke in float32: ``train_loss`` (the router
    balance term included) and every gradient leaf through the kernels on
    the card against the plain path on the CPU, normwise within 1e-4;
    attention launches once per forward of a layer (remat included)."""
    from repro_torch import tree
    from repro_torch.train.data import LMDataPipeline

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m-smoke"),
                              dtype="float32")
    cpu = transformer.init(cfg, torch.Generator().manual_seed(0))
    batch = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=4).batch_at(0)
    out = {}
    for device in ("cuda", "cpu"):
        params = tree.tree_map(lambda t: t.to(device), cpu)
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        fa_kernel.reset_launch_count()
        loss = transformer.train_loss(
            tree.unflatten(params, leaves),
            tree.tree_map(lambda t: t.to(device), batch), cfg,
            use_kernel=True)
        out[device] = (loss.detach(), torch.autograd.grad(loss, leaves))
        if device == "cuda":
            assert fa_kernel.launch_count("simt") == 2 * cfg.num_layers
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for path, a, b in zip(tree.flatten(cpu), gg, gc):
        assert _normwise_err(a.cpu(), b) <= 1e-4, path[0]


@pytest.mark.gpu
def test_compiled_entry_matches_solve_on_card(card):
    """``Estimator.lower(problem).compile()`` on cuda:0: the ``Compiled``
    entry's solution is ``solve``'s bit for bit, and one scan launch per
    call; lowering after a solve is a hit of the private cache."""
    from repro_torch.core import ExecutableCache

    model, recs = _wiener_records([400], torch.Generator().manual_seed(5))
    ts, y = recs[0]
    problem = Problem.single(model, ts, y)
    cache = ExecutableCache()
    est = Estimator(model, method="parallel_kernel", cache=cache,
                    options=KernelOptions(nsub=10, mode="discrete"))
    sol = est.solve(problem)
    compiled = est.lower(problem).compile()
    before = lqt_scan.launch_count()
    aot = compiled(problem.ts, problem.y)
    torch.cuda.synchronize()
    assert lqt_scan.launch_count() == before + 1
    assert (cache.hits, cache.misses) == (1, 1)
    assert aot.cov is None and sol.cov is None
    for f in ("x", "S", "v", "cost"):
        assert getattr(aot, f).device.type == "cuda"
        assert torch.equal(getattr(aot, f), getattr(sol, f)), f
    with pytest.raises(ValueError, match="compiled signature"):
        compiled(problem.ts[:-10], problem.y[:-10])


@pytest.mark.gpu
def test_cache_hit_after_fresh_solve_on_card(card):
    """A fresh solve on the card builds the entry (span ``compile``, one
    ``cache.compile_seconds`` sample), the repeat hits it (span
    ``execute``); each launches the scan once; an entry built for cuda:0
    is not replayed for the CPU."""
    from repro_torch import obs
    from repro_torch.core import ExecutableCache

    model, recs = _wiener_records([300, 300],
                                  torch.Generator().manual_seed(6))
    problem = Problem.stacked(model, recs[0][0],
                              np.stack([y for _, y in recs]))
    cache = ExecutableCache()
    opts = KernelOptions(nsub=10, mode="discrete")
    est = Estimator(model, method="parallel_kernel", options=opts,
                    cache=cache)
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        before = lqt_scan.launch_count()
        first = est.solve(problem)
        second = est.solve(problem)
        snap = obs.snapshot()
    finally:
        obs.reset()
        (obs.enable if was else obs.disable)()
    assert lqt_scan.launch_count() - before == 2
    assert (cache.hits, cache.misses) == (1, 1)
    h = snap["histograms"]
    assert h["cache.compile_seconds"]["count"] == 1
    assert h["span.estimator.solve.compile"]["count"] == 1
    assert h["span.estimator.solve.execute"]["count"] == 1
    assert torch.equal(first.x, second.x)
    cpu = Estimator(model, method="parallel_kernel", options=opts,
                    device="cpu", cache=cache).solve(problem)
    assert cache.misses == 2 and cpu.x.device.type == "cpu"
    assert float((cpu.x - first.x.cpu()).abs().max()) < 1e-8 * float(
        cpu.x.abs().max())


@pytest.mark.gpu
def test_pipeline_forward_on_repeated_card_matches_stack(card):
    """``pipeline_forward`` over hymba-1.5b-smoke's layers in 2 stages on a
    ``("pipe",)`` mesh of 2 x cuda:0, bf16, through the kernels: the
    unpipelined stack run microbatch by microbatch on the card, bit for
    bit, with one attention and one SSD launch per layer and
    microbatch."""
    from repro_torch import tree
    from repro_torch.distributed import Mesh, pipeline_forward

    cfg = dataclasses.replace(get_config("hymba-1.5b-smoke"), num_layers=4)
    params = transformer.init(cfg, card)
    S, M, L, per = 2, 3, 64, 2
    stage_params = tree.tree_map(lambda a: a.reshape(S, per, *a.shape[1:]),
                                 params["layers"])
    positions = torch.arange(L, dtype=torch.float32, device="cuda")

    def layers(p, x, n):
        for layer in transformer._unstack(p, n):
            x = transformer._layer_forward(layer, x, cfg, positions, True)
        return x

    x = torch.randn(M, 2, L, cfg.d_model, generator=card,
                    device="cuda").to(torch.bfloat16)
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    with torch.no_grad():
        got = pipeline_forward(lambda p, h: layers(p, h, per), stage_params,
                               x, Mesh(["cuda:0"] * S, ("pipe",)))
        assert fa_kernel.launch_count() == cfg.num_layers * M
        assert ssd_kernel.launch_count() == cfg.num_layers * M
        want = torch.stack([layers(params["layers"], h, cfg.num_layers)
                            for h in x])
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_scan_combine_fn_on_card_launches_the_pairwise_kernel(card):
    """``scan_combine_fn()`` in the core prefix scan on the card: one
    pairwise launch per combine of the scan's tree (counted by running the
    tree with a counting combine), and a carried single element expanded
    in both orders, within 1e-8 of the plain combine (the reference's
    kernel-path bound)."""
    from repro_torch.core.combine import lqt_combine
    from repro_torch.core.pscan import associative_scan, prefix_scan
    from repro_torch.kernels.lqt_combine import scan_combine_fn

    nx, n = 4, 32

    def r(*s):
        return torch.randn(*s, generator=card, device="cuda",
                           dtype=torch.float64)

    def psd(*lead):
        A = r(*lead, nx, nx)
        return A @ A.transpose(-1, -2) / nx + 0.1 * torch.eye(
            nx, device="cuda", dtype=torch.float64)

    e = LQTElement(r(n, nx, nx) * 0.6, r(n, nx), psd(n), r(n, nx), psd(n))
    tree_combines = []
    associative_scan(lambda a, b: tree_combines.append(1) or a,
                     (torch.zeros(n),))
    before = lqt_kernel.launch_count()
    got = prefix_scan(scan_combine_fn(), e)
    torch.cuda.synchronize()
    assert lqt_kernel.launch_count() == before + len(tree_combines)
    want = prefix_scan(lqt_combine, e)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-8)
    one = LQTElement(*(x[0] for x in e))
    rest = LQTElement(*(x[1:] for x in e))
    for a, b in ((one, rest), (rest, one)):
        wide = [LQTElement(*(x.expand(y.shape) for x, y in zip(u, v)))
                if u.A.dim() == 2 else u for u, v in ((a, b), (b, a))]
        for g, w in zip(scan_combine_fn()(a, b), lqt_combine(*wide)):
            torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-8)


@pytest.mark.gpu
def test_sharded_checkpoint_on_repeated_card(card, tmp_path):
    """A sharded training state on a 2 x 2 mesh of cuda:0 saved and
    restored onto a (4, 1) mesh of cuda:0 and onto the card alone: every
    shard its slice of the saved global tensor, bit for bit, on the
    card."""
    import numpy as np_

    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import Mesh, mesh_context, spmd
    from repro_torch.train import adamw_init
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import make_shardings

    cfg = dataclasses.replace(get_config("smollm-135m-smoke"),
                              dtype="float32")
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    params = transformer.init(cfg, card)
    state = (params, adamw_init(params))

    def shardings(shape):
        mesh = Mesh(np_.array(["cuda:0"] * 4, dtype=object).reshape(shape),
                    ("data", "model"))
        with mesh_context(mesh):
            return make_shardings(cfg, tcfg, mesh)

    sharded = spmd.device_put(state, shardings((2, 2)))
    path = ckpt.save_checkpoint(str(tmp_path), 3, sharded)
    saved = torch.load(path, weights_only=True)["leaves"]
    for x, want in zip(tree.leaves(state), saved):
        assert torch.equal(x.cpu(), want)
    step, moved = ckpt.restore_checkpoint(path, state, shardings((4, 1)))
    assert step == 3
    for x, want in zip(tree.leaves(moved), saved):
        for pos in np_.ndindex(x.shards.shape):
            shard = x.shards[pos]
            assert shard.device.type == "cuda"
            assert torch.equal(shard.cpu(), want[x.index(pos)])
    _, plain = ckpt.restore_checkpoint(path, state)
    for x, want in zip(tree.leaves(plain), saved):
        assert x.device.type == "cuda" and torch.equal(x.cpu(), want)
