"""Tests of the port that need a CUDA card: the LM kernels on the card,
the whole-scan ``lqt_scan`` kernel against its plain scan, and the
nonlinear estimation paths (the iterated Taylor and sigma-point
smoothers) and the estimation serving engines (``TrajectoryEngine``,
``StreamingEngine``) through it.

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


# (B, Hq, Hkv, Lq, Lk, D, window): each head size of the tensor-core
# kernel; decode alignment (Lq < Lk); Lq, Lk off the 64-row tiles; windows
# off the tiles.
FA_MMA_CASES = [
    (2, 4, 2, 128, 128, 16, None),
    (1, 6, 2, 96, 160, 32, 40),
    (1, 4, 1, 1, 300, 64, None),
    (2, 8, 2, 100, 300, 128, 70),
    (1, 25, 5, 200, 200, 64, 100),
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
