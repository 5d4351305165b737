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


def cache_pspecs(cfg: ModelConfig, mesh, global_batch: int = 0):
    """PartitionSpecs for the stacked decode caches (``LayerCaches`` of
    ``KVCache``/``SSMCache`` specs).

    The leading axis is LAYERS, never sharded; the batch goes over (pod,
    data) with progressive fallback when it does not divide (long_500k has
    batch 1); kv/ssm heads over model with head_dim fallback (the weights'
    divisibility rule).
    """
    from repro_torch.distributed.sharding import PartitionSpec as P
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    from repro_torch.models.transformer import LayerCaches

    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    while data_axes and global_batch:
        size = 1
        for a in data_axes:
            size *= mesh.shape[a]
        if global_batch % size == 0:
            break
        data_axes = data_axes[1:]
    d = (data_axes if len(data_axes) > 1 else
         (data_axes[0] if data_axes else None))
    m = mesh.shape["model"] if "model" in mesh.axis_names else 1

    attn = ssm = None
    if cfg.mixer in ("attn", "hybrid"):
        if cfg.num_kv_heads % m == 0:
            kv = P(None, d, "model", None, None)
        elif cfg.hd % m == 0 and not cfg.kv_replicate:
            kv = P(None, d, None, None, "model")
        else:
            kv = P(None, d, None, None, None)
        attn = KVCache(k=kv, v=kv, pos=P(None))
    if cfg.mixer in ("ssm", "hybrid"):
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        conv = P(None, d, None, "model" if conv_dim % m == 0 else None)
        if cfg.ssm_heads % m == 0:
            state = P(None, d, "model", None, None)
        elif cfg.ssm_head_dim % m == 0:
            state = P(None, d, None, "model", None)
        else:
            state = P(None, d, None, None, None)
        ssm = SSMCache(conv=conv, state=state)
    return LayerCaches(attn, ssm)


def cache_layout(cfg: ModelConfig, mesh, global_batch: int = 0):
    """PartitionSpecs of the stacked decode caches as the sharded executor
    lays them out: :func:`cache_pspecs`, except where the ambient
    ``mesh_context`` of ``mesh`` puts the batch on the model axis too
    (the dp-only policy).  There each cache's batch dimension takes the
    batch's own spec (``choose_pspec`` of ``"batch"``, with its
    fallback) and no dimension is model-sharded, so that the rows of each
    data group lie whole on its own position.  (The reference keeps
    :func:`cache_pspecs`' layout under dp-only and lets GSPMD re-lay the
    caches; wherever the model axis divides a cache dimension, one
    device's bytes are the same.)"""
    from repro_torch.distributed import sharding as shd

    specs = cache_pspecs(cfg, mesh, global_batch)
    ctx = shd._CTX
    if ctx.mesh is not mesh or ctx.model_axis not in ctx.data_axes:
        return specs
    rows = (shd.choose_pspec((global_batch,), ("batch",), mesh)[0]
            if global_batch else ctx.data_axes)
    return type(specs)(*(None if c is None else type(c)(*(
        shd.PartitionSpec(*(rows if i == 1 else None for i in range(len(sp))))
        for sp in c)) for c in specs))

