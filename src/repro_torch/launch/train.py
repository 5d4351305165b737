"""Training entry point: the LM ``Trainer`` on the synthetic LM pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 4 --batch 8 --seq 2048 --microbatches 2 --ckpt-dir <dir>

Runs on the CUDA card (``--device cpu`` for the CPU) from random weights
seeded by ``--seed``; the CUDA kernels are built at first use.  A run
resumes from the newest checkpoint in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import TrainConfig, get_config
from repro_torch.train.data import LMDataPipeline
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b-smoke",
                    help="a registered architecture (repro_torch.configs."
                         "ARCHS) or its -smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        seq_len=args.seq, global_batch=args.batch,
        microbatches=args.microbatches, seed=args.seed,
        checkpoint_every=args.ckpt_every, log_every=args.log_every)
    pipeline = LMDataPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
    trainer = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipeline,
                      ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"device={trainer.device}", flush=True)
    return trainer.run(args.steps)


if __name__ == "__main__":
    main()
