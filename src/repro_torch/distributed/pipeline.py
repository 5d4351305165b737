"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (the port of
``repro/distributed/pipeline.py``).

The layers are stacked per stage (weights ``(stages, layers_per_stage,
...)``); stage ``s`` runs on the ``s``-th device of the mesh's ``pipe``
axis.  Microbatches stream through the stages: the schedule runs
``M + S - 1`` ticks for ``M`` microbatches over ``S`` stages (the GPipe
bubble), and at tick ``t`` stage ``s`` works on microbatch ``t - s`` and
hands its activation to stage ``s + 1`` by ``Tensor.to``.  One host
thread drives every stage, as the rest of the single-controller mesh does
(:mod:`repro_torch.distributed.sharding`): launches are asynchronous, so
on distinct cards a tick's stages can overlap.  The reference computes
every (stage, tick) pair and discards the inactive ones; this computes only
the active pairs, which gives the same outputs.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree

from .sharding import Mesh, device_scope


def pipeline_forward(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                     mesh: Mesh, axis_name: str = "pipe") -> torch.Tensor:
    """Run microbatches through pipeline stages.

    ``stage_fn(params_stage, x) -> x`` is one stage's computation (the
    output has the input's shape); ``stage_params`` a tree whose leaves
    carry a leading stage axis of ``mesh.shape[axis_name]``; ``x_micro``
    ``(M, ...)`` the microbatched input.  Returns the last stage's ``(M,
    ...)`` outputs on ``x_micro``'s device.
    """
    devices = mesh.axis_devices(axis_name)
    S, M = len(devices), x_micro.shape[0]
    sizes = {leaf.shape[0] for leaf in tree.leaves(stage_params)}
    if sizes != {S}:
        raise ValueError(
            f"stage_params leaves need a leading stage axis of {S} (the "
            f"{axis_name!r} axis), got {sorted(sizes)}")
    params = [tree.tree_map(lambda a, s=s, d=d: a[s].to(d), stage_params)
              for s, d in enumerate(devices)]
    home = x_micro.device
    buf = [None] * S                  # the activation waiting at stage s
    outs = [None] * M
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(max(0, t - M + 1), min(S, t + 1)):
            mb = t - s
            with device_scope(devices[s]):
                x = x_micro[mb].to(devices[s]) if s == 0 else buf[s]
                y = stage_fn(params[s], x)
            if s == S - 1:
                outs[mb] = y.to(home)
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        buf = nxt
    return torch.stack(outs)
