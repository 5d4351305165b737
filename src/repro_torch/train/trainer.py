"""Training loop: the train-step factory, microbatching, checkpoints,
preemption handling.

``make_train_step`` builds the step for a model config: loss -> gradients
(per-layer remat in the model stack) -> accumulation over microbatches in
float32 -> AdamW.  The port runs it eagerly.  Given params, optimizer state
and batch laid out by ``make_shardings`` and the batch's spec
(``repro_torch.distributed.spmd.device_put``) under ``mesh_context(mesh)``,
it runs sharded (the reference jits it with those shardings): TP over
"model", ZeRO-1 optimizer state over "data" (``TrainConfig.zero1``), expert
parallelism; the design is in ``repro_torch.distributed.spmd``.

Fault tolerance: ``Trainer.run`` checkpoints every ``checkpoint_every``
steps, at the last step and on SIGTERM, resumes from the newest
checkpoint, and keeps the data pipeline stateless (step-indexed) so a
restart replays the same batches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.estimator import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.models import transformer

from . import checkpoint as ckpt
from .optimizer import (
    AdamWState, adamw_apply, adamw_init, adamw_update, cosine_schedule,
    opt_state_axes,
)


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params``, in leaf order.  A leaf the loss does not use (the
    token table of an embeddings-input model) gets a zero gradient, as
    under ``jax.grad``."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tuple(torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads))


def make_shardings(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """NamedShardings for (params, opt_state) under ``mesh``: params TP over
    "model" by the logical rules, the optimizer state also ZeRO-1 over the
    data axes when ``tcfg.zero1``."""
    axes = transformer.axes(cfg)
    shapes = transformer.shapes(cfg)
    p_shard = shd.tree_shardings(axes, shapes, mesh)
    data_size = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            data_size *= mesh.shape[a]
    o_axes = opt_state_axes(axes, shapes, data_size, zero1=tcfg.zero1)
    o_shard = AdamWState(
        step=shd.NamedSharding(mesh, shd.PartitionSpec()),
        m=shd.tree_shardings(o_axes.m, shapes, mesh),
        v=shd.tree_shardings(o_axes.v, shapes, mesh),
        master=shd.tree_shardings(o_axes.master, shapes, mesh))
    return p_shard, o_shard


def _sharded_step(params, opt: AdamWState, batch, *, cfg, tcfg, loss_fn,
                  schedule, compute_dtype):
    """The step on ShardedTensors (``repro_torch.distributed.spmd``): returns
    params and optimizer state in the layouts they came in, the metrics as
    tensors on the mesh's first device, and the step's collectives under
    ``"collectives"``."""
    layout = spmd.Layout.of(params)
    mesh = layout.mesh
    if shd.active_mesh() not in (None, mesh):
        raise ValueError("a sharded step runs under its own mesh's "
                         "mesh_context")
    ctx = (shd.mesh_context(mesh) if shd.active_mesh() is None
           else contextlib.nullcontext())
    log = spmd.CollectiveLog()
    with ctx, spmd.recording(log), spmd.step_scope():
        groups = layout.runners(batch)
        home = groups[0].home
        leaves, per_leaf = spmd.grad_leaves(params, groups, layout)
        # ZeRO-2: each microbatch's gradients are reduced straight into the
        # optimizer state's layout (the reference constrains them to the
        # zero1 layout of the ambient data axes, which is the same layout
        # wherever the batch axes are the data axes)
        g_shard = tree.tree_map(lambda x: x.sharding, opt.m)
        n = tcfg.microbatches
        loss, acc = None, None
        for mb in ([batch] if n == 1 else
                   spmd.microbatches(batch, n, groups)):
            mb_loss = loss_fn(leaves, mb)
            g = spmd.device_put(tree.unflatten(params, spmd.partial_grads(
                mb_loss, leaves, per_leaf)), g_shard)
            mb_loss = mb_loss.detach()
            if acc is None:
                loss, acc = mb_loss, g
            else:
                loss = loss + mb_loss
                torch._foreach_add_(_shards(acc), _shards(g))
            del g
        if n > 1:
            inv = 1.0 / n
            loss = loss * inv
            torch._foreach_mul_(_shards(acc), inv)
        gnorm = spmd.global_norm(acc, home)
        step = np.empty(opt.step.shards.shape, dtype=object)
        for pos in np.ndindex(step.shape):
            dev = mesh.devices[pos]
            s = opt.step.shards[pos]
            step[pos] = s + 1
            adamw_apply([x.shards[pos] for x in tree.leaves(acc)],
                        *([x.shards[pos] for x in tree.leaves(t)]
                          for t in (opt.m, opt.v, opt.master)),
                        gnorm.to(dev), step[pos], schedule(s), tcfg)
        del acc
        new_params = tree.tree_map(
            lambda master, p: spmd.cast_into(master, p.sharding,
                                             compute_dtype),
            opt.master, params)
    lr = schedule(opt.step.shards.flat[0]).to(home)
    new_opt = AdamWState(
        spmd.ShardedTensor(step, opt.step.sharding, opt.step.shape),
        opt.m, opt.v, opt.master)
    return new_params, new_opt, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                                 "collectives": log}


def _shards(t) -> list:
    return [s for x in tree.leaves(t) for s in x.shards.flat]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)``.

    ``loss_fn(params, batch)`` defaults to ``transformer.train_loss`` on
    the plain path.  With ``tcfg.microbatches > 1`` the batch is split on
    its leading axis and the microbatches' gradients are summed in float32
    buffers, then averaged, as the reference's accumulation scan does.
    ``opt`` is updated in place (see ``optimizer.adamw_update``).

    On ShardedTensors (see the module docstring) the step runs sharded and
    returns params and optimizer state in the same layouts, with the loss,
    grad_norm and lr on the mesh's first device and the step's
    ``CollectiveLog`` under ``metrics["collectives"]``.  ``loss_fn`` must
    then take sharded params and batch, as ``transformer.train_loss``
    does.
    """
    schedule = cosine_schedule(tcfg)
    loss_fn = loss_fn or functools.partial(transformer.train_loss, cfg=cfg)
    compute_dtype = {"bfloat16": torch.bfloat16,
                     "float32": torch.float32}[cfg.dtype]

    grads_of = functools.partial(value_and_grad, loss_fn)

    def step(params, opt: AdamWState, batch):
        if spmd.is_sharded(params):
            return _sharded_step(params, opt, batch, cfg=cfg, tcfg=tcfg,
                                 loss_fn=loss_fn, schedule=schedule,
                                 compute_dtype=compute_dtype)
        n = tcfg.microbatches
        if n > 1:
            parts = [x.reshape((n, -1) + tuple(x.shape[1:])).unbind(0)
                     for x in tree.leaves(batch)]
            micro = [tree.unflatten(batch, [p[i] for p in parts])
                     for i in range(n)]
            loss, g = grads_of(params, micro[0])
            acc = [x.float() for x in g]
            del g
            for mb in micro[1:]:
                mb_loss, g = grads_of(params, mb)
                loss = loss + mb_loss
                torch._foreach_add_(acc, g)
                del g
            inv = 1.0 / n
            loss = loss * inv
            torch._foreach_mul_(acc, inv)
            grads = tree.unflatten(params, acc)
        else:
            loss, g = grads_of(params, batch)
            grads = tree.unflatten(params, g)
        params, opt, stats = adamw_update(grads, opt, tcfg, schedule,
                                          compute_dtype)
        return params, opt, {"loss": loss, **stats}

    return step


def _to_device(batch, device):
    return tree.tree_map(lambda x: x.to(device, non_blocking=True), batch)


@dataclasses.dataclass
class Trainer:
    """Trains ``cfg`` from seeded random weights on ``pipeline``'s batches.

    ``device`` is ``None`` for the card (raises without one) or ``"cpu"``.
    The default loss is ``transformer.train_loss`` through the CUDA kernels
    on a card, and through the kernels' plain versions on the CPU.

    ``on_step(step, metrics)``, if given, is called after each step's
    update (``step`` counts from 1; ``metrics`` holds the step's tensors)
    and before its checkpoint.  ``run`` sets ``start_step`` (the restored
    step, 0 when fresh) and appends ``(step, path, seconds)`` to ``saves``
    for each checkpoint written.
    """
    cfg: ModelConfig
    tcfg: TrainConfig
    pipeline: Any
    ckpt_dir: str
    loss_fn: Optional[Callable] = None
    log_fn: Callable = print
    device: Any = None
    on_step: Optional[Callable[[int, dict], None]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._stop_requested = False
        self.start_step = 0
        self.saves: list[tuple[int, str, float]] = []

    def _install_sigterm(self):
        def handler(signum, frame):
            self._stop_requested = True
            self.log_fn("[trainer] SIGTERM: will checkpoint and exit")

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not in the main thread (tests)

    def run(self, steps: Optional[int] = None):
        previous = self._install_sigterm()
        try:
            return self._run(steps)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, steps):
        cfg, tcfg = self.cfg, self.tcfg
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        params = transformer.init(cfg, gen)
        opt = adamw_init(params)
        start_step = 0

        latest = ckpt.latest_checkpoint(self.ckpt_dir)
        if latest:
            start_step, (params, opt) = ckpt.restore_checkpoint(
                latest, (params, opt))
            self.log_fn(f"[trainer] resumed from {latest} @ {start_step}")
        self.start_step = start_step

        loss_fn = self.loss_fn or functools.partial(
            transformer.train_loss, cfg=cfg,
            use_kernel=self.device.type == "cuda")
        step_fn = make_train_step(cfg, tcfg, loss_fn)
        total = steps if steps is not None else tcfg.total_steps
        metrics = {}
        t0 = time.time()
        for step in range(start_step, total):
            batch = _to_device(self.pipeline.batch_at(step), self.device)
            params, opt, metrics = step_fn(params, opt, batch)
            if self.on_step is not None:
                self.on_step(step + 1, metrics)
            if (step + 1) % tcfg.log_every == 0:
                loss = float(metrics["loss"])
                dt = (time.time() - t0) / tcfg.log_every
                self.log_fn(
                    f"[trainer] step {step + 1} loss={loss:.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.4f} "
                    f"lr={float(metrics['lr']):.2e} {dt:.2f}s/step")
                t0 = time.time()
            want_ckpt = ((step + 1) % tcfg.checkpoint_every == 0
                         or self._stop_requested or step + 1 == total)
            if want_ckpt:
                t_save = time.time()
                path = ckpt.save_checkpoint(
                    self.ckpt_dir, step + 1, (params, opt))
                ckpt.prune_checkpoints(self.ckpt_dir,
                                       tcfg.keep_checkpoints)
                seconds = time.time() - t_save
                self.saves.append((step + 1, path, seconds))
                self.log_fn(f"[trainer] saved {path} in {seconds:.2f}s")
            if self._stop_requested:
                break
        return params, opt, metrics
