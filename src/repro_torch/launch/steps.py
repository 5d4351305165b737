"""Step functions and abstract input specs for every cell kind.

``input_specs(cfg, shape)`` returns the inputs of the cell's step function
as tensors on the ``meta`` device (shapes and dtypes, no storage), the
port's counterpart of the reference's ``jax.ShapeDtypeStruct`` specs.

Cell kinds:
  train   -> ``train_step``  (loss + grads + AdamW update)
  prefill -> ``prefill_step`` (full forward, last-token logits + caches)
  decode  -> ``serve_step``  (one token against a seq_len-deep cache)
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import transformer
from repro_torch.models.layers import map_spec
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")


def _dtype(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {}
        if cfg.input_mode == "embeddings":
            specs["embeddings"] = _spec((B, S, cfg.d_model), _dtype(cfg))
        else:
            specs["tokens"] = _spec((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        return specs
    # decode: one token + caches of depth seq_len
    return {"tokens": _spec((B,), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                   device=META)


def params_specs(cfg: ModelConfig) -> dict:
    return map_spec(lambda p: _spec(p.shape, _dtype(cfg)),
                    transformer.model_spec(cfg))


def opt_specs(cfg: ModelConfig):
    return adamw_init(params_specs(cfg))


def make_step(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
              **model_kw):
    """Returns (step_fn, example_kwargs_specs) for the cell."""
    if shape.kind == "train":
        loss_fn = functools.partial(
            transformer.train_loss, cfg=cfg, **model_kw)
        train_step = make_train_step(cfg, tcfg, loss_fn)
        specs = {
            "params": params_specs(cfg),
            "opt": opt_specs(cfg),
            "batch": batch_specs(cfg, shape),
        }
        return train_step, specs

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return transformer.prefill(
                params, batch, cfg, max_len=shape.seq_len, **model_kw)

        return prefill_step, {
            "params": params_specs(cfg),
            "batch": batch_specs(cfg, shape),
        }

    def serve_step(params, tokens, caches):
        return transformer.decode_step(params, tokens, caches, cfg)

    return serve_step, {
        "params": params_specs(cfg),
        "tokens": batch_specs(cfg, shape)["tokens"],
        "caches": cache_specs(cfg, shape),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                tcfg: TrainConfig = None) -> Dict[str, Any]:
    _, specs = make_step(cfg, shape, tcfg or TrainConfig())
    return specs
