"""Gradient compression for the data-parallel all-reduce (the port of
``repro/distributed/grad_compress.py``).

A bf16 all-reduce with float32 ERROR FEEDBACK: each step the residual of
the previous compression is added back before quantising, so the
compression error does not accumulate (it is re-injected and eventually
transmitted) -- the standard EF-SGD construction.  It halves the bytes of
the gradient reduction.

The reference calls :func:`compressed_psum` inside a ``shard_map`` over
the data axis.  The port is single-controller: the function takes the
per-shard gradients, one tree per device of the axis, and returns one
result per shard, as the reference's shard-mapped call holds one on each
device.  Nothing in the ``Trainer`` reads it, as in the reference
(``TrainConfig.grad_compress`` stays unwired); the sharded step of
``train.trainer.make_train_step`` sums gradients in float32 into
the ZeRO-1 layout that ``TrainConfig.zero1`` selects (``make_shardings``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch import tree

from .sharding import Mesh, device_scope


def init_error_state(grads_like) -> Any:
    """Float32 zeros of ``grads_like``'s structure and shapes."""
    return tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


def compressed_psum(grads: Sequence, err: Sequence, mesh: Mesh,
                    axis_name: str) -> Tuple[List, List]:
    """bf16 all-reduce with float32 error feedback.

    ``grads`` and ``err``: one tree per device of ``axis_name``, shard
    ``j``'s on ``mesh.axis_devices(axis_name)[j]`` (an error state of
    :func:`init_error_state` per shard to start).  Each shard forms
    ``target = g.float() + e`` and ``q = target.bfloat16()``; its new error
    is ``target - q.float()``.  The reduction sums ``q.float()`` over the
    axis and divides by its size.  Returns ``(means, new_errs)``: the
    float32 mean on every shard's device, and each shard's new error.
    """
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    if len(grads) != n or len(err) != n:
        raise ValueError(
            f"compressed_psum takes one gradient and one error tree per "
            f"device of the {axis_name!r} axis ({n}), got {len(grads)} and "
            f"{len(err)}")
    qs, new_errs = [], []
    for g_j, e_j in zip(grads, err):
        target = [g.float() + e for g, e in zip(tree.leaves(g_j),
                                                tree.leaves(e_j))]
        q = [t.bfloat16().float() for t in target]
        qs.append(q)
        new_errs.append(tree.unflatten(e_j, [t - x for t, x in
                                             zip(target, q)]))
    home = devices[0]
    total = [x.to(home) for x in qs[0]]
    for q in qs[1:]:
        total = [a + x.to(home) for a, x in zip(total, q)]
    mean = [a / n for a in total]
    means = [tree.unflatten(grads[0], [m.to(d) for m in mean])
             for d in devices]
    return means, new_errs


def make_compressed_dp_step(loss_fn: Callable, optimizer_update: Callable,
                            mesh: Mesh, axis_name: str = "data") -> Callable:
    """A data-parallel train step with compressed gradient sync.

    ``loss_fn(params, batch) -> scalar``; ``optimizer_update(grads, opt,
    params) -> (params, opt)``.  Returns ``step(params, opt, err, batch) ->
    (params, opt, err, loss)``: the batch's leaves are split on their
    leading axis over ``axis_name``; shard ``j`` computes the loss and its
    gradient on its device from its copy of the params; the loss is the
    mean over the shards (``pmean``), the gradients go through
    :func:`compressed_psum` and then ``optimizer_update``.  ``params`` and
    ``opt`` are one replicated copy on the axis's first device (every
    shard reads it, and the mean the update takes is the same on every
    shard); ``err`` holds one error tree per shard, as the reference's
    replicated error holds its own residual on each device.
    """
    # imported here: repro_torch.train imports the model stack, which a
    # user of the meshes alone does not need
    from repro_torch.train.trainer import value_and_grad

    devices = mesh.axis_devices(axis_name)
    n = len(devices)

    def step(params, opt, err, batch):
        sizes = {x.shape[0] for x in tree.leaves(batch)}
        if len(sizes) != 1 or next(iter(sizes)) % n:
            raise ValueError(
                f"batch leading dims {sorted(sizes)} do not split over the "
                f"{axis_name!r} axis of {n}")
        k = next(iter(sizes)) // n
        losses, grads = [], []
        for j, dev in enumerate(devices):
            with device_scope(dev):
                p_j = tree.tree_map(lambda a: a.to(dev), params)
                b_j = tree.tree_map(lambda a: a[j * k:(j + 1) * k].to(dev),
                                    batch)
                loss, g = value_and_grad(loss_fn, p_j, b_j)
            losses.append(loss.to(devices[0]))
            grads.append(tree.unflatten(params, g))
        mean_loss = torch.stack(losses).mean()
        means, err = compressed_psum(grads, err, mesh, axis_name)
        params, opt = optimizer_update(means[0], opt, params)
        return params, opt, err, mean_loss

    return step
