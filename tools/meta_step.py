#!/usr/bin/env python3
"""Host seconds of one sharded training step on a mesh of ``meta``
devices (shapes only, no storage, no card):

    PYTHONPATH=src python3 tools/meta_step.py [--arch hymba-1.5b]
        [--layers 2] [--batch 32] [--seq 512] [--mesh 16x16] [--memo]

Lays out ``make_shardings``' parameters and optimizer state (zero1) and a
batch of ``batch x seq`` tokens over a (data, model) mesh of ``meta``
devices, runs ``make_train_step`` once, and prints the seconds of the
lay-out and of the step, and the step's collective log by kind.
``--memo`` runs it under the dry-run's operator memo
(``repro_torch.launch.dryrun.MetaRun``), as ``python -m
repro_torch.launch.dryrun`` does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--memo", action="store_true")
    args = ap.parse_args()

    from repro_torch import tree
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.distributed import Mesh, mesh_context, spmd
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import MetaRun
    from repro_torch.train.trainer import make_shardings, make_train_step

    d, m = (int(x) for x in args.mesh.split("x"))
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    tcfg = TrainConfig(zero1=True)
    mesh = Mesh(np.array(["meta"] * (d * m), dtype=object).reshape(d, m),
                ("data", "model"))
    meta = torch.device("meta")
    batch = {k: torch.empty((args.batch, args.seq), dtype=torch.int32,
                            device=meta) for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    memo = MetaRun() if args.memo else contextlib.nullcontext()
    with mesh_context(mesh), memo:
        p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
        b_sh = tree.tree_map(lambda x: shd.named_sharding(
            x.shape, ("batch",) + (None,) * (x.dim() - 1)), batch)
        params = steps.params_specs(cfg)
        opt = spmd.device_put(steps.opt_specs(cfg), o_sh)
        params = spmd.device_put(params, p_sh)
        batch = spmd.device_put(batch, b_sh)
        t1 = time.perf_counter()
        _, _, metrics = make_train_step(cfg, tcfg)(params, opt, batch)
        t2 = time.perf_counter()
    by_kind = metrics["collectives"].by_kind()
    print(json.dumps({
        "arch": args.arch, "layers": args.layers,
        "tokens": [args.batch, args.seq], "mesh": [d, m],
        "memo": args.memo,
        "layout_s": round(t1 - t0, 3), "step_s": round(t2 - t1, 3),
        "collectives": {k: {"count": n, "bytes": b}
                        for k, (n, b) in sorted(by_kind.items())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
