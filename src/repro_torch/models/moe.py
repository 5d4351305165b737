"""Mixture-of-experts FFN: top-k routing and sort-based capacity dispatch.

Each token picks its top-k experts by router probability and its gates
are renormalised over them.  Token-slot assignments are ranked within
their expert by a stable sort (earlier tokens win); assignments past the
per-expert capacity are dropped and their gate weight is lost (standard
dropping-MoE semantics).  Expert compute is batched over the expert axis:
(E, cap, D) x (E, D, F) products on a dense dispatch buffer.

On sharded weights (``repro_torch.distributed.spmd``) the expert FFN runs
per model shard: with the expert axis split, each shard runs its E/m
experts of the buffer (expert parallelism) and the outputs are
all-gathered; with d_ff split (E does not divide the model axis), each
shard runs its slice of every expert and the outputs are summed.  Data
groups route their tokens together (``moe_forward_groups``), so capacity
and drops are those of the whole batch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd

from .layers import P, activation


def moe_spec(cfg: ModelConfig) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    spec = {
        "router": P((D, E), ("embed", None)),
        "wu": P((E, D, F_), ("experts", "embed", "ff"), fan_in=D),
        "wd": P((E, F_, D), ("experts", "ff", "embed"), fan_in=F_),
    }
    if cfg.mlp_type == "gated":
        spec["wg"] = P((E, D, F_), ("experts", "embed", "ff"), fan_in=D)
    return spec


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` tokens, the reference's formula:
    the cf-scaled mean load, floored at k and ceiled at T * k, rounded up
    to a multiple of 128 above 128.  An expert takes at most one
    assignment per token, so a batch of at most k tokens (a decode step at
    batch <= k) never drops."""
    E, K = cfg.moe_experts, cfg.moe_topk
    cap = int(max(K, (K * tokens / E) * cfg.moe_capacity_factor))
    cap = min(cap, tokens * K)
    cap = (cap + 127) // 128 * 128 if cap > 128 else cap
    return min(cap, tokens * K)


class Routing(NamedTuple):
    """The dispatch of T tokens, assignment i = token i // k's (i % k)-th
    choice: ``gate`` (T, k) float32 renormalised, ``idx`` (T, k) experts,
    ``slot`` (T * k,) its row in the expert's buffer (cap - 1 when
    dropped), ``keep`` (T * k,) bool, ``cap`` slots per expert."""
    gate: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def _router_probs(router, xt):
    # the product in the parameter dtype, the softmax in float32
    return torch.softmax((xt @ router).float(), dim=-1)


def choose(params, xt, cfg: ModelConfig, idx=None) -> tuple:
    """``(gate, idx)``: each token's top-k experts (or the choices ``idx``)
    and their gates renormalised over them."""
    probs = _router_probs(params["router"], xt)
    if idx is None:
        gate, idx = torch.topk(probs, cfg.moe_topk, dim=-1)
    else:
        gate = probs.gather(-1, idx)
    return gate / gate.sum(dim=-1, keepdim=True), idx


def place(gate, idx, cfg: ModelConfig, cap: int, prior=None,
          rows=None) -> Routing:
    """The slots of the assignments ``idx`` (T, k) at ``cap`` slots per
    expert.  ``prior`` (E,): assignments to each expert by the tokens of
    the batch before these (another data group's), which rank first;
    ``rows``: the buffer's rows per expert (default ``cap``; they must hold
    every kept assignment)."""
    T, K = idx.shape
    E = cfg.moe_experts
    e_flat = idx.reshape(T * K)
    # rank each assignment within its expert (stable: earlier tokens win)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=idx.device))
    rank_sorted = torch.arange(T * K, device=idx.device) - start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap if prior is None else rank + prior[e_flat] < cap
    rows = cap if rows is None else rows
    slot = torch.where(keep, rank, rows - 1)
    return Routing(gate, idx, slot, keep, rows)


def route(params, xt, cfg: ModelConfig, idx=None) -> Routing:
    """Top-k routing and capacity slots of the tokens ``xt`` (T, D).
    ``idx`` (T, k), when given, are the expert choices to take instead of
    the top k; their gates are still the router's probabilities."""
    gate, idx = choose(params, xt, cfg, idx)
    return place(gate, idx, cfg, capacity(xt.shape[0], cfg))


def _experts(buf, wu, wg, wd, cfg: ModelConfig):
    """The gated (or plain) expert FFN on the dispatch buffer (E, cap, D)."""
    act = activation(cfg.act)
    up = torch.bmm(buf, wu)
    if cfg.mlp_type == "gated":
        hidden = act(torch.bmm(buf, wg)) * up
    else:
        hidden = act(up)
    return torch.bmm(hidden, wd)


def _dispatch_apply(params, xt, r: Routing, cfg: ModelConfig):
    """Scatter the kept assignments of ``xt`` (T, D) into the (E, cap, D)
    buffer, run the experts, and sum each token's k outputs by its
    gates."""
    T, D = xt.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    # row of each assignment in the flattened (E * cap, D) buffers
    row = r.idx.reshape(T * K) * r.cap + r.slot

    # scatter the kept assignments into (E, cap, D).  Kept rows are
    # unique, so a copy equals the reference's scatter-add (where a dropped
    # assignment adds zeros at slot cap - 1); dropped ones are copied to a
    # spare last row that is cut off, so their gradient is zero, as there
    x_rep = xt[:, None].expand(T, K, D).reshape(T * K, D)
    spare = torch.where(r.keep, row, E * r.cap)
    buf = torch.zeros((E * r.cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf = buf.index_copy(0, spare, x_rep)[:-1].view(E, r.cap, D)

    # experts split over the model shards run their part of the buffer
    # (expert parallelism); experts split on ff sum their partial outputs
    wu, wg, wd = params["wu"], params.get("wg"), params["wd"]
    ep = isinstance(wu, spmd.Shards) and wu.dim == 0
    out_buf = spmd.shard_map(functools.partial(_experts, cfg=cfg), (buf,),
                             (wu, wg, wd), split_dims=(0 if ep else None,),
                             out=("gather", 0) if ep else "sum")

    gathered = torch.where(r.keep[:, None],
                           out_buf.reshape(E * r.cap, D).index_select(0, row),
                           0)
    # the weighted sum over k: bfloat16 products accumulated in float32
    # and rounded once, as the reference's jnp sum takes them
    return (gathered.reshape(T, K, D)
            * r.gate.to(gathered.dtype)[..., None]).sum(dim=1)


def moe_forward(params, x, cfg: ModelConfig, idx=None):
    """x: (B, S, D) -> (B, S, D); ``idx`` as in ``route`` (the expert
    choices of another pass, to compare two paths at the same routing)."""
    Bb, S, D = x.shape
    xt = x.reshape(Bb * S, D)
    return _dispatch_apply(params, xt, route(params, xt, cfg, idx),
                           cfg).reshape(Bb, S, D)


def _counts(idx, E: int):
    """Assignments to each of the ``E`` experts (a scatter-add, which
    also runs on ``meta`` tensors, where ``bincount``'s size is unknown)."""
    flat = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def moe_forward_groups(params_list: list, xs: list, cfg: ModelConfig,
                       groups: list) -> list:
    """The MoE layer on the data groups' tokens (``xs``, one (B, S, D) per
    group, in batch order) as one batch: the capacity is the whole
    batch's, and an assignment's rank within its expert counts the
    earlier groups' assignments first (their per-expert counts
    all-gathered over the data axes), so the kept assignments are those
    of ``moe_forward`` on the joined batch.  Each group dispatches and
    combines its own tokens; its buffer holds min(cap, its tokens) rows
    per expert."""
    E = cfg.moe_experts

    def chosen_of(g, p, x):
        xt = x.reshape(-1, x.shape[-1])
        return (xt,) + choose(p, xt, cfg)

    chosen = spmd.per_group(groups, chosen_of, params_list, xs)
    every = spmd.all_gather([_counts(idx, E)[None] for _, _, idx in chosen],
                            0, groups[0].home)
    cap = capacity(sum(xt.shape[0] for xt, _, _ in chosen), cfg)

    def out_of(g, i, p, x, c):
        xt, gate, idx = c
        prior = every[:i].sum(dim=0).to(g.home)
        r = place(gate, idx, cfg, cap, prior, min(cap, xt.shape[0]))
        return _dispatch_apply(p, xt, r, cfg).reshape(x.shape)

    return spmd.per_group(groups, out_of, range(len(groups)), params_list,
                          xs, chosen)


def _router_top1(params, x, cfg: ModelConfig) -> tuple:
    D = x.shape[-1]
    probs = _router_probs(params["router"], x.reshape(-1, D))
    _, idx = torch.topk(probs, cfg.moe_topk, dim=-1)
    return probs, F.one_hot(idx[:, 0], cfg.moe_experts).float()


def moe_aux_loss(params, x, cfg: ModelConfig):
    """Load-balancing auxiliary loss (Switch-style): E times the sum over
    experts of the top-1 token fraction times the mean probability."""
    probs, onehot = _router_top1(params, x, cfg)
    frac_tokens = onehot.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.moe_experts * torch.sum(frac_tokens * frac_probs)


def router_sums(params, x, cfg: ModelConfig) -> list:
    """``[top-1 counts, summed probabilities]`` (E,) of the tokens ``x``:
    the terms of ``moe_aux_loss`` that data groups add up."""
    probs, onehot = _router_top1(params, x, cfg)
    return [onehot.sum(dim=0), probs.sum(dim=0)]
