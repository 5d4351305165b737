"""Tests of the port that need a CUDA card: the LM kernels on the card.

They skip without a card.  This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` configures JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
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
