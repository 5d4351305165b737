"""Serving entry point: batched greedy generation with the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --requests 16 --prompt-len 2048 --new-tokens 32 --batch 8 \
        --max-len 2080

Runs on the CUDA card (``--device cpu`` for the CPU) with random weights
from a seeded generator; the CUDA kernels are built at first use.  Any
token-input decoder of ``repro_torch.configs.ARCHS`` (or its ``-smoke``
config) serves; encoders are refused here, and ``ServeEngine`` refuses an
embeddings-input backbone.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.core.estimator import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b-smoke",
                    help="a registered architecture (repro_torch.configs."
                         "ARCHS) or its -smoke config")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only architectures have no decode step")
    device = resolve_device(args.device)
    params = transformer.init(cfg, torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(cfg, params, batch=args.batch,
                         max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"[serve] arch={cfg.name} {len(done)} requests, "
          f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt={r.prompt[:6]}... out={r.out}")


if __name__ == "__main__":
    main()
