"""Batched serving engine: prefill + decode in fixed-size waves.

Requests are served in waves of ``batch``: each wave's prompts are
left-padded with token 0 to the longest prompt (the pad tokens are
attended, as in the reference), prefilled once, then decoded greedily one
token per step until every request of the wave has its
``max_new_tokens``.  The schedule is the reference's
(``repro/serving/engine.py``) exactly, so both engines produce the same
tokens from the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.estimator import resolve_device
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
      cfg, params: the model and its parameter tree (moved to ``device``).
        Prompts are tokens, so an embeddings-input model (an encoder or a
        VLM backbone) raises ``ValueError``.
      batch: requests per wave; max_len: cache length (prompt + new tokens).
      greedy: only greedy decoding exists (as in the reference).
      device: ``None`` means ``"cuda"`` and raises without a card; pass
        ``"cpu"`` to run on the CPU.
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
        self.params = _to_device(params, self.device)
        self.batch = batch
        self.max_len = max_len
        self.greedy = greedy
        self.use_kernel = use_kernel

    def _prefill(self, tokens):
        return transformer.prefill(self.params, {"tokens": tokens}, self.cfg,
                                   max_len=self.max_len,
                                   use_kernel=self.use_kernel)

    def _decode(self, tokens, caches):
        return transformer.decode_step(self.params, tokens, caches, self.cfg)

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
