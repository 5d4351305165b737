"""Training loop: the train-step factory, microbatching, checkpoints,
preemption handling.

``make_train_step`` builds the step for a model config: loss -> gradients
(per-layer remat in the model stack) -> accumulation over microbatches in
float32 -> AdamW.  The reference jits the same step and, under a mesh,
shards it; the port runs it eagerly on one device.

Fault tolerance: ``Trainer.run`` checkpoints every ``checkpoint_every``
steps, at the last step and on SIGTERM, resumes from the newest
checkpoint, and keeps the data pipeline stateless (step-indexed) so a
restart replays the same batches.
"""
from __future__ import annotations

import dataclasses
import functools
import signal
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.estimator import resolve_device
from repro_torch.models import transformer

from . import checkpoint as ckpt
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_schedule


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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)``.

    ``loss_fn(params, batch)`` defaults to ``transformer.train_loss`` on
    the plain path.  With ``tcfg.microbatches > 1`` the batch is split on
    its leading axis and the microbatches' gradients are summed in float32
    buffers, then averaged, as the reference's accumulation scan does.
    ``opt`` is updated in place (see ``optimizer.adamw_update``).
    """
    schedule = cosine_schedule(tcfg)
    loss_fn = loss_fn or functools.partial(transformer.train_loss, cfg=cfg)
    compute_dtype = {"bfloat16": torch.bfloat16,
                     "float32": torch.float32}[cfg.dtype]

    grads_of = functools.partial(value_and_grad, loss_fn)

    def step(params, opt: AdamWState, batch):
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
