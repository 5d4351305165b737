"""The language-model stack: decoder/encoder LMs with attn / ssm / hybrid
mixers and dense or mixture-of-experts FFNs.

Weights are stacked over layers on a leading axis, as in the reference;
where the reference scans over that axis (``lax.scan``), the port loops
over it in Python.  ``train_loss`` honours the reference's remat choices
with ``torch.utils.checkpoint``: ``remat`` checkpoints each layer and
``remat_group`` adds a checkpoint around each group of layers (nested).

Public entry points:
  init / axes / shapes        parameter tree + logical sharding metadata
  train_loss                  tokens/embeddings -> scalar loss
                              (differentiable)
  prefill                     full-sequence forward -> logits + caches
  decode_step                 one token with caches -> logits + caches
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    NamedSharding, PartitionSpec, choose_pspec,
)

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (
    P, activation, apply_rope, init_params, layer_slice, params_axes,
    params_shapes, rms_norm, rope_freqs, stack_specs,
)


def _mlp_spec(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    spec = {
        "wu": P((D, F_), ("embed", "ff")),
        "wd": P((F_, D), ("ff", "embed")),
    }
    if cfg.mlp_type == "gated":
        spec["wg"] = P((D, F_), ("embed", "ff"))
    return spec


def layer_spec(cfg: ModelConfig) -> dict:
    spec: dict = {"ln1": P((cfg.d_model,), ("embed",), init="ones")}
    if cfg.mixer in ("attn", "hybrid"):
        spec["attn"] = attn_mod.attn_spec(cfg)
    if cfg.mixer in ("ssm", "hybrid"):
        spec["ssm"] = ssm_mod.ssm_spec(cfg)
    if cfg.mixer == "hybrid":
        spec["attn_out_norm"] = P((cfg.d_model,), ("embed",), init="ones")
        spec["ssm_out_norm"] = P((cfg.d_model,), ("embed",), init="ones")
    if cfg.is_moe:
        spec["ln2"] = P((cfg.d_model,), ("embed",), init="ones")
        spec["moe"] = moe_mod.moe_spec(cfg)
    elif cfg.mlp_type != "none" and cfg.d_ff > 0:
        spec["ln2"] = P((cfg.d_model,), ("embed",), init="ones")
        spec["mlp"] = _mlp_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    spec: dict = {
        "layers": stack_specs(layer_spec(cfg), cfg.num_layers),
        "final_norm": P((D,), ("embed",), init="ones"),
    }
    if cfg.input_mode == "tokens" or not cfg.is_encoder:
        spec["embed"] = P((V, D), ("vocab", "embed_model"), fan_in=D)
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((D, V), ("embed_model", "vocab"))
    return spec


def _dtype(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    """Random weights from ``generator`` (on its device unless ``device``
    says otherwise), in the config's dtype."""
    return init_params(generator, model_spec(cfg), _dtype(cfg), device)


def axes(cfg: ModelConfig) -> dict:
    return params_axes(model_spec(cfg))


def shapes(cfg: ModelConfig) -> dict:
    return params_shapes(model_spec(cfg))


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _mlp(x, wu, wg, wd, cfg):
    act = activation(cfg.act)
    h = x @ wu
    if cfg.mlp_type == "gated":
        h = act(x @ wg) * h
    else:
        h = act(h)
    return h @ wd


def _apply_mlp(p, x, cfg):
    # split on ff: each model shard runs its slice and the outputs sum
    return spmd.shard_map(functools.partial(_mlp, cfg=cfg), (x,),
                          (p["wu"], p.get("wg"), p["wd"]), out="sum")


def _embed_in(params, batch, cfg: ModelConfig):
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(_dtype(cfg))
    return spmd.embedding(batch["tokens"], params["embed"])


def _lm_logits(params, x, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = spmd.einsum("bld,dv->blv", x, head, torch.matmul)
    if cfg.padded_vocab != cfg.vocab_size:
        # physical vocab padding: mask the pad columns
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _norm(x, w, cfg: ModelConfig):
    """``rms_norm`` position by position: per sequence block where ``x``
    is split by sequence (``spmd.SeqSplit``)."""
    return spmd.rowwise(lambda x, w: rms_norm(x, w, cfg.norm_eps), (x,),
                        (w,))


def _add(x, y):
    """The residual add, per sequence block where ``x`` is split."""
    return spmd.rowwise(torch.add, (x, y))


def _mix(p, a, s, cfg):
    """Hybrid mixer: the branch outputs normalised, then averaged."""
    eps = cfg.norm_eps
    return spmd.rowwise(lambda a, s, wa, ws: 0.5 * (
        rms_norm(a, wa, eps) + rms_norm(s, ws, eps)), (a, s),
        (p["attn_out_norm"], p["ssm_out_norm"]))


def _ffn(p, x, cfg):
    if "moe" in p:
        x = x + moe_mod.moe_forward(p["moe"],
                                    rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    elif "mlp" in p:
        with spmd.seq_scope(x):
            out = _apply_mlp(p["mlp"], spmd.seq_gather(_norm(
                x, p["ln2"], cfg)), cfg)
        x = _add(x, out)
    return x


def _mixer_residual(p, x, cfg: ModelConfig, positions, use_kernel,
                    causal_skip=False):
    """``x`` plus the mixers of its norm.  Where ``x`` is split by
    sequence (sequence parallelism), the norm and the add run per block,
    the mixers' input is all-gathered and their row-parallel outputs are
    reduce-scattered (``spmd.seq_scope``)."""
    with spmd.seq_scope(x):
        mix = _mixers(p, spmd.seq_gather(_norm(x, p["ln1"], cfg)), cfg,
                      positions, use_kernel, causal_skip)
    return _add(x, mix)


def _mixers(p, h, cfg: ModelConfig, positions, use_kernel, causal_skip):
    if cfg.mixer == "attn":
        mix = attn_mod.attention_forward(p["attn"], h, cfg, positions,
                                         use_kernel=use_kernel,
                                         causal_skip=causal_skip)
    elif cfg.mixer == "ssm":
        mix = ssm_mod.ssm_forward(p["ssm"], h, cfg, use_kernel=use_kernel)
    else:
        a = attn_mod.attention_forward(p["attn"], h, cfg, positions,
                                       use_kernel=use_kernel,
                                       causal_skip=causal_skip)
        s = ssm_mod.ssm_forward(p["ssm"], h, cfg, use_kernel=use_kernel)
        mix = _mix(p, a, s, cfg)
    return mix


def _layer_forward(p, x, cfg: ModelConfig, positions, use_kernel,
                   causal_skip=False):
    return _ffn(p, _mixer_residual(p, x, cfg, positions, use_kernel,
                                   causal_skip), cfg)


def _layer_forward_groups(ps, xs, *, groups, cfg: ModelConfig, positions,
                          use_kernel, causal_skip=False):
    """One layer for every data group (``ps``/``xs``/``positions``: one
    each per group), in lockstep: a MoE layer routes the groups' tokens
    together (``moe.moe_forward_groups``)."""
    ys = spmd.per_group(groups, lambda g, p, x, pos: _mixer_residual(
        p, x, cfg, pos, use_kernel, causal_skip), ps, xs, positions)
    return _ffn_groups(ps, ys, groups, cfg)


def _ffn_groups(ps, ys, groups, cfg: ModelConfig) -> list:
    """The FFN of every data group's residual stream ``ys``, in lockstep
    for a MoE layer."""
    if "moe" not in ps[0]:
        return spmd.per_group(groups, lambda g, p, y: _ffn(p, y, cfg), ps,
                              ys)
    hs = spmd.per_group(groups, lambda g, p, y: spmd.seq_gather(_norm(
        y, p["ln2"], cfg)), ps, ys)
    outs = moe_mod.moe_forward_groups([p["moe"] for p in ps], hs, cfg,
                                      groups)
    return spmd.per_group(groups, lambda g, y, o: _add(y, o), ys, outs)


def _unstack(tree: dict, n: int) -> list:
    """Per-layer trees of a tree stacked over ``n`` layers, by one
    ``torch.unbind`` per leaf: its backward writes every layer's gradient
    into one buffer of the leaf's size (taking ``v[i]`` per layer would
    add a zero-filled gradient of the whole leaf for each layer)."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _per_group_params(ps, groups, take) -> list:
    """``take(p)`` of each group's params ``p``; on ``meta`` devices, where
    ``spmd.per_group`` runs the first group only, its result stands for
    every group's."""
    first = take(ps[0])
    return [first if i and g.home.type == "meta" else take(p)
            for i, (g, p) in enumerate(zip(groups, ps))]


def _checkpointed(fn, *args):
    # the layers draw no random numbers: no RNG state to restore; the
    # recomputation sees the sharded executor's state of the first run
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=spmd.recompute_context)


def _grouped(cfg: ModelConfig) -> bool:
    # the reference's unrolled stack has no group checkpoint
    g, n = cfg.remat_group, cfg.num_layers
    return bool(g) and n % g == 0 and n > g and not cfg.unroll_layers


def _stack_forward(params, x, cfg: ModelConfig, positions, *,
                   use_kernel=False, causal_skip=False):
    """The layers, then the final norm."""
    layers = _unstack(params["layers"], cfg.num_layers)
    step = functools.partial(_layer_forward, cfg=cfg, positions=positions,
                             use_kernel=use_kernel, causal_skip=causal_skip)
    x = _run_stack(step, layers, x, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _run_stack(step, layers: list, x, cfg: ModelConfig):
    """``x`` through ``step(layer, x)`` for each layer.  ``remat``
    checkpoints each layer; ``remat_group = g`` (with ``g`` dividing and
    below the depth, and the layers not unrolled, as in the reference)
    also checkpoints each group of ``g`` layers, nested."""
    if cfg.remat:
        step = functools.partial(_checkpointed, step)

    def run(x, lo, hi):
        for p in layers[lo:hi]:
            x = step(p, x)
        return x

    n = cfg.num_layers
    if _grouped(cfg):
        for lo in range(0, n, cfg.remat_group):
            x = _checkpointed(run, x, lo, lo + cfg.remat_group)
    else:
        x = run(x, 0, n)
    return x


def train_loss(params, batch, cfg: ModelConfig, *, use_kernel=False,
               causal_skip=False, moe_aux_weight: float = 0.01):
    """Next-token (decoder) or masked-position (encoder) cross-entropy, in
    float32, plus ``moe_aux_weight`` times the router balance loss of the
    first layer for MoE models.

    batch: ``{"tokens": (B, L) int}`` (or ``"embeddings"`` (B, L, D) for
    ``input_mode="embeddings"``), ``"labels": (B, L) int`` and optionally
    ``"loss_mask"`` (B, L).  ``use_kernel`` runs the attention and SSD
    forwards through the CUDA kernels (``attention_trainable``,
    ``ssd_trainable``); their backward passes are autograd through the
    plain versions, as in the reference.  ``causal_skip`` runs the plain
    attention's triangular schedule (``attention.chunked_mha``).

    On ``ShardedTensor`` params and batch (``repro_torch.distributed.spmd``)
    the loss is that of the whole batch, computed by the data groups in
    lockstep, on the mesh's first device; with ``cfg.seq_parallel`` the
    residual stream runs split by sequence over the model axis between
    the layers (``_seq_parallel``).  On plain tensors ``seq_parallel``
    changes nothing, as the reference's pin is the identity without a
    mesh.
    """
    if spmd.is_sharded(params):
        return _sharded_train_loss(params, batch, cfg, use_kernel,
                                   moe_aux_weight, causal_skip)
    x = _embed_in(params, batch, cfg)
    L = x.shape[1]
    positions = torch.arange(L, dtype=torch.float32, device=x.device)
    h = _stack_forward(params, x, cfg, positions, use_kernel=use_kernel,
                       causal_skip=causal_skip)
    logits = _lm_logits(params, h, cfg)
    labels = batch["labels"].long()  # < vocab_size, never a pad column
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.is_moe:
        # the first layer's router probed on the embedded input (not the
        # layer's normed input), as in the reference
        aux = moe_mod.moe_aux_loss(
            layer_slice(params["layers"]["moe"], 0), x, cfg)
        loss = loss + moe_aux_weight * aux
    return loss


def _seq_parallel(cfg: ModelConfig, layout, shape) -> bool:
    """Whether the residual stream of a sharded train step, of global
    ``shape`` (B, L, D), runs split by sequence between the layers, as the
    reference pins it to ``("batch", "seq_sp", None)``: with
    ``cfg.seq_parallel``, where ``choose_pspec`` puts ``seq_sp`` on the
    model axis (of more than one device, dividing L, and not taken by the
    batch, as it is under dp-only)."""
    if not cfg.seq_parallel or layout.m == 1:
        return False
    spec = choose_pspec(shape, ("batch", "seq_sp", None), layout.mesh)
    return len(spec) > 1 and spec[1] == layout.model_axis


def _sharded_train_loss(params, batch, cfg: ModelConfig, use_kernel: bool,
                        moe_aux_weight: float, causal_skip: bool = False):
    """``train_loss`` on sharded params and batch (the design is in
    ``repro_torch.distributed.spmd``).  Each data group's terms, the summed
    negative log-likelihood and token count (and, for MoE models, the
    first layer's top-1 counts and summed router probabilities over the
    embedded input), are all-reduced over the data axes; the loss is the
    whole batch's, as ``train_loss`` forms it."""
    layout = spmd.Layout.of(params)
    groups = layout.runners(batch)
    lead = tree.leaves(batch)[0]
    sp = _seq_parallel(cfg, layout, tuple(lead.shape[:2]) + (cfg.d_model,))
    with spmd.step_scope():
        ps = [spmd.views(params, g, layout) for g in groups]
        bs = [spmd.views(batch, g, layout, data=True) for g in groups]
        xs = spmd.per_group(groups, lambda g, p, b: _embed_in(p, b, cfg),
                            ps, bs)
        positions = [torch.arange(x.shape[1], dtype=torch.float32,
                                  device=g.home) for g, x in zip(groups, xs)]
        layers = list(zip(*_per_group_params(
            ps, groups, lambda p: _unstack(p["layers"], cfg.num_layers))))
        step = functools.partial(_layer_forward_groups, groups=groups,
                                 cfg=cfg, positions=positions,
                                 use_kernel=use_kernel,
                                 causal_skip=causal_skip)
        hs = xs
        if sp:      # the stream enters the layers split by sequence
            hs = spmd.per_group(groups, lambda g, x: spmd.seq_split(
                x, g.devices), xs)
        hs = _run_stack(step, layers, hs, cfg)
        if sp:
            hs = spmd.per_group(groups, lambda g, h: spmd.seq_gather(h), hs)

        def terms(g, p, b, h, x):
            logits = _lm_logits(p, rms_norm(h, p["final_norm"],
                                            cfg.norm_eps), cfg)
            labels = b["labels"].long()
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, labels[..., None])[..., 0]
            mask = b.get("loss_mask")
            mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
            t = [-(ll * mask).sum()[None], mask.sum()[None]]
            if cfg.is_moe:
                t += moe_mod.router_sums(layer_slice(p["layers"]["moe"], 0),
                                         x, cfg)
            return torch.cat(t)

        total = spmd.all_reduce(spmd.per_group(groups, terms, ps, bs, hs,
                                               xs), groups[0].home)
    loss = total[0] / torch.clamp(total[1], min=1.0)
    if cfg.is_moe:
        E = cfg.moe_experts
        tokens = sum(x.shape[0] * x.shape[1] for x in xs)
        ones, probs = total[2:2 + E] / tokens, total[2 + E:] / tokens
        loss = loss + moe_aux_weight * (E * torch.sum(ones * probs))
    return loss


class LayerCaches(NamedTuple):
    attn: Optional[Any] = None
    ssm: Optional[Any] = None


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed caches stacked over layers (a leading num_layers axis)."""
    dt = _dtype(cfg)

    def stack(c):
        return type(c)(*(torch.zeros((cfg.num_layers,) + tuple(a.shape),
                                     dtype=a.dtype, device=a.device)
                         for a in c))

    attn = ssmc = None
    if cfg.mixer in ("attn", "hybrid"):
        attn = stack(attn_mod.init_kv_cache(cfg, batch, max_len, dt, device))
    if cfg.mixer in ("ssm", "hybrid"):
        ssmc = stack(ssm_mod.init_ssm_cache(cfg, batch, dt, device))
    return LayerCaches(attn, ssmc)


def _layer_cache(caches: LayerCaches, i: int) -> LayerCaches:
    """Layer ``i``'s caches as views of the stacked ones."""
    return LayerCaches(*(None if c is None else type(c)(*(a[i] for a in c))
                         for c in caches))


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, max_len: int, *,
            use_kernel: bool = False):
    """Full-sequence forward that also fills the decode caches.

    batch: ``{"tokens": (B, L) int}`` (``{"embeddings": (B, L, D)}`` for
    ``input_mode="embeddings"``).  Returns the last position's logits
    (B, 1, V) and the caches stacked over layers.  As in the reference,
    each layer's caches come from re-running its mixers in cache-filling
    mode; ``use_kernel`` selects the CUDA kernels for the full-sequence
    attention and SSD.  Like the reference's, it takes no
    ``causal_skip``.

    On ``ShardedTensor`` params and batch (``repro_torch.distributed.spmd``)
    the data groups run in lockstep; the logits come back as a
    ``ShardedTensor`` split over the batch (all-gathered over ``vocab``)
    and the caches as ``ShardedTensor``\\ s laid out by
    ``launch.steps.cache_layout``.
    """
    if spmd.is_sharded(params):
        return _sharded_prefill(params, batch, cfg, max_len, use_kernel)
    x = _embed_in(params, batch, cfg)
    B, L = x.shape[:2]
    positions = torch.arange(L, dtype=torch.float32, device=x.device)
    caches = init_caches(cfg, B, max_len, x.device)
    for i in range(cfg.num_layers):
        x = _prefill_layer(layer_slice(params["layers"], i),
                           _layer_cache(caches, i), x, cfg=cfg,
                           positions=positions, use_kernel=use_kernel)
    if caches.attn is not None:
        caches.attn.pos.fill_(L)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, h[:, -1:], cfg), caches


def _prefill_layer(p, cache: LayerCaches, x, *, cfg, positions, use_kernel):
    """One layer over the sequence; writes its caches into ``cache`` (views
    of the zeroed stacked caches)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a = s = None
    if cfg.mixer in ("attn", "hybrid"):
        a = attn_mod.attention_forward(p["attn"], h, cfg, positions,
                                       use_kernel=use_kernel)
        k, v = _sequence_kv(p["attn"], h, cfg, positions, cache.attn.k)
        cache.attn.k[:, :, :k.shape[2]] = k
        cache.attn.v[:, :, :v.shape[2]] = v
    if cfg.mixer in ("ssm", "hybrid"):
        s = ssm_mod.ssm_forward(p["ssm"], h, cfg, use_kernel=use_kernel)
        tail, w, Bg = ssm_mod.prefill_streams(p["ssm"], h, cfg)
        cache.ssm.conv.copy_(tail)
        cache.ssm.state.copy_(ssm_mod.terminal_state(w, Bg, cfg))
    return _ffn(p, x + _mixer_out(p, a, s, cfg), cfg)


def _mixer_out(p, a, s, cfg: ModelConfig):
    if cfg.mixer == "attn":
        return a
    if cfg.mixer == "ssm":
        return s
    return _mix(p, a, s, cfg)


def _sequence_kv(p, h, cfg, positions, like):
    """The sequence's keys and values for the cache (B, Hkv, n, hd), rope'd
    at full ``hd``, ``n = min(L, W)`` for a cache ``like`` of W slots.

    When L >= W only the last W positions are kept, in slots 0..W-1, as
    in the reference; decode then writes position ``pos`` to slot
    ``pos % W``, so for L % W != 0 the first decode step overwrites a key
    that is not the oldest.  The port reproduces that quirk of the
    reference (ROADMAP.md, queue 3).  On a sharded ``wk``/``wv`` the
    projections are all-gathered (``spmd.einsum``).
    """
    L = h.shape[1]
    k = spmd.einsum("bld,dhk->blhk", h, p["wk"], attn_mod._proj_heads)
    v = spmd.einsum("bld,dhk->blhk", h, p["wv"], attn_mod._proj_heads)
    if cfg.qk_norm:
        k = rms_norm(k, spmd.local(p["k_norm"]), cfg.norm_eps)
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    k = apply_rope(k, cos[:, None], sin[:, None]).transpose(1, 2)
    v = v.transpose(1, 2)
    n = min(L, like.shape[-2])
    return k[:, :, L - n:], v[:, :, L - n:]


@torch.no_grad()
def decode_step(params, tokens, caches: LayerCaches, cfg: ModelConfig):
    """One decode step.  tokens: (B,) int -> logits (B, V), caches.

    The caches are updated in place (the reference returns new arrays):
    the returned ``LayerCaches`` shares the input's buffers, except the
    attention ``pos``, which is a new tensor one larger.  On sharded
    params, tokens and caches (as ``prefill`` returns them) the logits are
    a ``ShardedTensor`` split over the batch.
    """
    if spmd.is_sharded(params):
        return _sharded_decode(params, tokens, caches, cfg)
    x = F.embedding(tokens[:, None], params["embed"])
    new_pos = []
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        cache = _layer_cache(caches, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a = s = None
        if cfg.mixer in ("attn", "hybrid"):
            a, new_attn = attn_mod.attention_decode(lp["attn"], h, cfg,
                                                    cache.attn)
            new_pos.append(new_attn.pos)
        if cfg.mixer in ("ssm", "hybrid"):
            s, new_ssm = ssm_mod.ssm_decode(lp["ssm"], h, cfg, cache.ssm)
            cache.ssm.conv.copy_(new_ssm.conv)
            cache.ssm.state.copy_(new_ssm.state)
        x = _ffn(lp, x + _mixer_out(lp, a, s, cfg), cfg)
    attn = caches.attn
    if attn is not None:
        attn = attn_mod.KVCache(attn.k, attn.v, torch.stack(new_pos))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, h, cfg)[:, 0], LayerCaches(attn, caches.ssm)


# ---------------------------------------------------------------------------
# prefill and decode on sharded params and caches
# ---------------------------------------------------------------------------


def _sharded_caches(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Zeroed stacked caches as ``ShardedTensor``\\ s laid out by
    ``cache_layout`` (every position its own local tensors)."""
    from repro_torch.launch.steps import cache_layout

    like = init_caches(cfg, batch, max_len, torch.device("meta"))
    specs = cache_layout(cfg, mesh, batch)
    return LayerCaches(*(None if c is None else type(c)(*(
        spmd.zeros(a.shape, a.dtype, NamedSharding(mesh, sp))
        for a, sp in zip(c, cs))) for c, cs in zip(like, specs)))


def _runners(layout, batch):
    """The data groups that run (one per distinct slice of the batch) and
    each one's batch rows."""
    groups = layout.runners(batch)
    lead = tree.leaves(batch)[0]
    return groups, [lead.index(g.positions[0])[0] for g in groups]


def _sharded_prefill(params, batch, cfg: ModelConfig, max_len: int,
                     use_kernel: bool):
    """``prefill`` on sharded params and batch (the design is in
    ``repro_torch.distributed.spmd``).  Each data group runs its rows on
    its home, the layers in lockstep (a MoE layer routes the whole batch).
    Each cache piece is written on its own device: keys and values rope'd
    at full ``hd`` on the home, then split over kv heads or ``hd`` (with
    head-local attention, each model shard writes its own kv heads); the
    conv tail split over channels; the SSD state per state shard from
    that shard's heads (or head-dimension slice) and their groups' B
    columns."""
    layout = spmd.Layout.of(params)
    lead = tree.leaves(batch)[0]
    groups, rows = _runners(layout, batch)
    B, L = lead.shape[:2]
    caches = _sharded_caches(cfg, layout.mesh, B, max_len)
    with spmd.step_scope():
        ps = [spmd.views(params, g, layout) for g in groups]
        xs = spmd.per_group(groups, lambda g, p: _embed_in(
            p, spmd.views(batch, g, layout, data=True), cfg), ps)
        positions = [torch.arange(L, dtype=torch.float32, device=g.home)
                     for g in groups]
        for i in range(cfg.num_layers):
            lps = _per_group_params(ps, groups, lambda p: layer_slice(
                p["layers"], i))
            ys = spmd.per_group(
                groups, lambda g, lp, x, pos, r: x + _prefill_mixers_sharded(
                    lp, x, cfg, pos, caches, i, g, r, use_kernel),
                lps, xs, positions, rows)
            xs = _ffn_groups(lps, ys, groups, cfg)
        last = spmd.per_group(groups, lambda g, p, x: _lm_logits(
            p, rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps), cfg),
            ps, xs)
        logits = {(r.start, r.stop): v for r, v in zip(rows, last)}
    if caches.attn is not None:
        for t in caches.attn.pos.shards.flat:
            t.fill_(L)
    return _sharded_logits(logits, lead, (B, 1, cfg.padded_vocab)), caches


def _sharded_logits(values: dict, lead, shape):
    """Logits ``{rows: tensor}`` as a ShardedTensor split over the batch
    as ``lead`` (the batch's first leaf) is."""
    sh = NamedSharding(lead.mesh, PartitionSpec(lead.sharding.spec[0]
                                                if lead.sharding.spec
                                                else None))
    return spmd.from_rows(values, sh, shape)


def _prefill_mixers_sharded(p, x, cfg: ModelConfig, positions, caches,
                            layer: int, group, rows, use_kernel):
    """One data group's mixers over the sequence, with their caches."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a = s = None
    if cfg.mixer in ("attn", "hybrid"):
        pa, kv = p["attn"], caches.attn
        a = attn_mod.attention_forward(pa, h, cfg, positions,
                                       use_kernel=use_kernel)
        if spmd.head_local(pa):
            parts = []
            for j, dev in enumerate(group.devices):
                with spmd.on_shard(j, dev):
                    w = {k: pa[k].parts[j] for k in ("wk", "wv")}
                    kn = spmd.local(pa.get("k_norm"))
                    w["k_norm"] = None if kn is None else kn.to(dev)
                    parts.append(_sequence_kv(w, h.to(dev), cfg,
                                              positions.to(dev), kv.k))
            spmd.write_rows(kv.k, layer, rows, parts=[k for k, _ in parts])
            spmd.write_rows(kv.v, layer, rows, parts=[v for _, v in parts])
        else:
            k, v = _sequence_kv(pa, h, cfg, positions, kv.k)
            spmd.write_rows(kv.k, layer, rows, k)
            spmd.write_rows(kv.v, layer, rows, v)
    if cfg.mixer in ("ssm", "hybrid"):
        s = ssm_mod.ssm_forward(p["ssm"], h, cfg, use_kernel=use_kernel)
        tail, w, Bg = ssm_mod.prefill_streams(p["ssm"], h, cfg)
        spmd.write_rows(caches.ssm.conv, layer, rows, tail)
        state = caches.ssm.state
        k = spmd.Layout(state.mesh).cache_dim(state)
        if k is None:
            spmd.write_rows(state, layer, rows,
                            ssm_mod.terminal_state(w, Bg, cfg))
        else:
            m = len(group.devices)
            H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
            parts = []
            for j, dev in enumerate(group.devices):
                with spmd.on_shard(j, dev):
                    hs, pslice = slice(None), slice(None)
                    if k == 2:
                        hs = slice(j * H // m, (j + 1) * H // m)
                    else:
                        pslice = slice(j * Pd // m, (j + 1) * Pd // m)
                    parts.append(ssm_mod.terminal_state_part(
                        w, Bg, cfg, hs, pslice, dev))
            spmd.write_rows(state, layer, rows, parts=parts)
    return _mixer_out(p, a, s, cfg)


def _sharded_decode(params, tokens, caches: LayerCaches, cfg: ModelConfig):
    """``decode_step`` on sharded params, tokens (B,) and caches: the data
    groups decode their rows in lockstep against their cache shards
    (``attention.attention_decode_sharded``,
    ``ssm.ssm_decode_sharded``); the FFN as in prefill."""
    layout = spmd.Layout.of(params)
    groups, rows = _runners(layout, tokens)
    attn = caches.attn
    with spmd.step_scope():
        ps = [spmd.views(params, g, layout) for g in groups]
        xs = spmd.per_group(groups, lambda g, p: spmd.embedding(
            spmd.views(tokens, g, layout, data=True)[:, None], p["embed"]),
            ps)

        def mixers(g, lp, x, r, i):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a = s = None
            if attn is not None:
                a = attn_mod.attention_decode_sharded(
                    lp["attn"], h, cfg, attn.k, attn.v,
                    attn.pos.shards[g.positions[0]][i], i, g, r)
            if caches.ssm is not None:
                s = ssm_mod.ssm_decode_sharded(lp["ssm"], h, cfg,
                                               caches.ssm.conv,
                                               caches.ssm.state, i, g, r)
            return x + _mixer_out(lp, a, s, cfg)

        for i in range(cfg.num_layers):
            lps = _per_group_params(ps, groups, lambda p: layer_slice(
                p["layers"], i))
            ys = spmd.per_group(groups, lambda g, lp, x, r: mixers(
                g, lp, x, r, i), lps, xs, rows)
            xs = _ffn_groups(lps, ys, groups, cfg)
        last = spmd.per_group(groups, lambda g, p, x: _lm_logits(
            p, rms_norm(x, p["final_norm"], cfg.norm_eps), cfg)[:, 0], ps, xs)
        logits = {(r.start, r.stop): v for r, v in zip(rows, last)}
    if attn is not None:
        pos = attn.pos
        shards = np.empty(pos.shards.shape, dtype=object)
        for at in np.ndindex(shards.shape):
            shards[at] = pos.shards[at] + 1
        attn = attn_mod.KVCache(attn.k, attn.v, spmd.ShardedTensor(
            shards, pos.sharding, pos.shape))
    return (_sharded_logits(logits, tokens, (tokens.shape[0],
                                             cfg.padded_vocab)),
            LayerCaches(attn, caches.ssm))
