"""AdamW with an fp32 master copy, the cosine schedule, and ZeRO-1 axes.

The reference's optimizer (``repro/train/optimizer.py``) in PyTorch.  The
state holds fp32 ``m``, ``v`` and ``master`` trees and an int32 ``step``;
:func:`adamw_update` returns the new params in the compute dtype.  The
arithmetic is the reference's, in its order: the learning rate from the
step before the update, the bias corrections from the step after it, and
the clip scale applied to the gradients before the moments.

Unlike the reference, which returns new arrays (and lets XLA reuse the old
ones' buffers), :func:`adamw_update` updates ``m``, ``v`` and ``master``
in place and returns a state that shares them: at a 1.6 B-parameter model
a second copy of the three would be 20 GB.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree as tree_util
from repro_torch.config import TrainConfig
from repro_torch.distributed.sharding import map_axes


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: dict
    v: dict
    master: dict        # fp32 master params (mixed-precision training)


def adamw_init(params) -> AdamWState:
    f32 = torch.float32
    leaf = tree_util.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_util.tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                             params),
        v=tree_util.tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                             params),
        master=tree_util.tree_map(lambda p: p.to(f32, copy=True), params),
    )


def cosine_schedule(cfg: TrainConfig) -> Callable:
    """``lr(step)``: linear warm-up, then a cosine decay to 0 at
    ``total_steps``; a float32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step)
        warm = cfg.learning_rate * (step + 1) / max(cfg.warmup_steps, 1)
        prog = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.learning_rate * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cos).float()

    return lr


def global_norm(tree) -> torch.Tensor:
    """The l2 norm of all leaves together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_util.leaves(tree)))


def adamw_update(grads, state: AdamWState, cfg: TrainConfig,
                 schedule: Callable, compute_dtype=torch.bfloat16):
    """One AdamW step; returns ``(new_compute_params, new_state, stats)``.

    ``grads`` has the params' structure (any float dtype).  ``state.m``,
    ``state.v`` and ``state.master`` are updated in place.
    """
    gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule(state.step)
    adamw_apply(tree_util.leaves(grads), tree_util.leaves(state.m),
                tree_util.leaves(state.v), tree_util.leaves(state.master),
                gnorm, step, lr, cfg)
    new_params = tree_util.tree_map(
        lambda x: x.to(compute_dtype, copy=True), state.master)
    return new_params, AdamWState(step, state.m, state.v, state.master), {
        "grad_norm": gnorm, "lr": lr}


def adamw_apply(grads: list, m: list, v: list, p: list, gnorm, step, lr,
                cfg: TrainConfig) -> None:
    """The AdamW arithmetic on lists of gradients and of fp32 moments and
    master weights (updated in place), given the whole gradient's norm
    ``gnorm``, the step after the update and its learning rate: the
    clip scale, the moments, the bias-corrected update with weight
    decay.  A sharded step calls it once per optimizer-state shard."""
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    g = [x.float() for x in grads]
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        # a new list: an fp32 gradient is its own .float()
        g = torch._foreach_mul(g, scale)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    del g
    for mi, vi, pi in zip(m, v, p):   # leaf by leaf: temporaries of one leaf
        upd = (mi / bc1).div_((vi / bc2).sqrt_().add_(eps))
        pi.sub_(upd.add_(pi, alpha=wd).mul_(lr))


# ---------------------------------------------------------------------------
# ZeRO-1 sharding metadata
# ---------------------------------------------------------------------------

def zero1_logical(axes: tuple, shape: tuple, data_size: int) -> tuple:
    """Replace the first data-shardable unsharded axis with 'zero1'.

    An axis is eligible when its logical name would not be model-sharded
    (None or 'embed') and its size divides the data-parallel degree;
    ``repro_torch.distributed.sharding.choose_pspec`` maps 'zero1' onto the
    data axes.
    """
    out = list(axes)
    for i, (name, dim) in enumerate(zip(axes, shape)):
        if name in (None, "embed") and dim % data_size == 0 \
                and dim >= data_size:
            out[i] = "zero1"
            return tuple(out)
    return tuple(out)


def opt_state_axes(param_axes, param_shapes, data_size: int,
                   zero1: bool = True) -> AdamWState:
    """Logical axes trees for (m, v, master) given the params' axes."""
    def leaf(ax, shp):
        return zero1_logical(ax, shp, data_size) if zero1 else ax

    zax = map_axes(leaf, param_axes, param_shapes)
    return AdamWState(step=(), m=zax, v=zax, master=zax)
