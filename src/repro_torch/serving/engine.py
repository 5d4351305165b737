"""Batched serving engine: prefill + decode in fixed-size waves.

Requests are served in waves of ``batch``: each wave's prompts are
left-padded with token 0 to the longest prompt (the pad tokens are
attended, as in the reference), prefilled once, then decoded greedily one
token per step until every request of the wave has its
``max_new_tokens``.  The schedule is the reference's
(``repro/serving/engine.py``) exactly, so both engines produce the same
tokens from the same weights.

Sharded params (``ShardedTensor``\\ s laid out by
``train.trainer.make_shardings``) are served under their mesh's ambient
``mesh_context`` (with ``sharding.policy_kw("dp_only")`` for the dp-only
policy), as the reference's engine runs unmodified on a mesh:
each wave's prompt batch and each step's tokens are laid out over the
``batch`` axes, prefill and decode run sharded
(``transformer.prefill``/``decode_step``), the caches stay sharded, and
the logits are gathered to the engine's device for the greedy choice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.estimator import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.models import transformer


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    """Greedy generation over ``transformer.prefill``/``decode_step``.

    Args:
      cfg, params: the model and its parameter tree (moved to ``device``;
        sharded params stay where they are, see the module docstring).
        Prompts are tokens, so an embeddings-input model (an encoder or a
        VLM backbone) raises ``ValueError``.
      batch: requests per wave; max_len: cache length (prompt + new tokens).
      greedy: only greedy decoding exists (as in the reference).
      device: ``None`` means ``"cuda"`` and raises without a card; pass
        ``"cpu"`` to run on the CPU.  With sharded params, where the
        prompts start from and the logits are gathered to.
      use_kernel: prefill through the CUDA kernels (flash attention and
        chunked SSD).  ``False`` runs the plain chunked paths, which is
        what the reference's engine runs.
    """

    def __init__(self, cfg: ModelConfig, params, batch: int = 4,
                 max_len: int = 512, greedy: bool = True, *, device=None,
                 use_kernel: bool = True):
        if cfg.input_mode != "tokens":
            # the reference's engine prefills from tokens as well
            raise ValueError(
                f"{cfg.name} takes input_mode={cfg.input_mode!r}: "
                f"ServeEngine prefills from token prompts only")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sharded = spmd.is_sharded(params)
        self.params = params if self.sharded else _to_device(params,
                                                             self.device)
        self.batch = batch
        self.max_len = max_len
        self.greedy = greedy
        self.use_kernel = use_kernel

    def _lay_out(self, tokens):
        """``tokens`` split over the ambient mesh's batch axes (sharded
        params), or as they are."""
        if not self.sharded:
            return tokens
        if shd.active_mesh() is None:
            raise ValueError("sharded params are served under their mesh's "
                             "mesh_context")
        return spmd.device_put(tokens, shd.named_sharding(
            tokens.shape, ("batch",) + (None,) * (tokens.dim() - 1)))

    def _gathered(self, out):
        logits, caches = out
        if self.sharded:
            logits = spmd.gather(logits, self.device)
        return logits, caches

    def _prefill(self, tokens):
        return self._gathered(transformer.prefill(
            self.params, {"tokens": self._lay_out(tokens)}, self.cfg,
            max_len=self.max_len, use_kernel=self.use_kernel))

    def _decode(self, tokens, caches):
        return self._gathered(transformer.decode_step(
            self.params, self._lay_out(tokens), caches, self.cfg))

    def _sample(self, logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in waves of ``batch``."""
        queue = list(requests)
        done: List[Request] = []
        while queue:
            wave = queue[:self.batch]
            queue = queue[self.batch:]
            prompts = [r.prompt for r in wave]
            T = max(len(p) for p in prompts)
            toks = np.zeros((self.batch, T), np.int64)
            for i, p in enumerate(prompts):
                toks[i, T - len(p):] = p   # left-pad to align last token
            logits, caches = self._prefill(
                torch.as_tensor(toks, device=self.device))
            cur = self._sample(logits[:, -1])
            steps = max(r.max_new_tokens for r in wave)
            outs = [[] for _ in wave]
            for i, r in enumerate(wave):
                outs[i].append(cur[i])
            for _ in range(steps - 1):
                logits, caches = self._decode(
                    torch.as_tensor(cur, dtype=torch.int64,
                                    device=self.device), caches)
                cur = self._sample(logits)
                for i, r in enumerate(wave):
                    if len(outs[i]) < r.max_new_tokens:
                        outs[i].append(cur[i])
            for i, r in enumerate(wave):
                r.out = np.asarray(outs[i], np.int32)
                done.append(r)
        return done
