"""Mixture-of-experts FFN: top-k routing and sort-based capacity dispatch.

Each token picks its top-k experts by router probability and its gates
are renormalised over them.  Token-slot assignments are ranked within
their expert by a stable sort (earlier tokens win); assignments past the
per-expert capacity are dropped and their gate weight is lost (standard
dropping-MoE semantics).  Expert compute is batched over the expert axis:
(E, cap, D) x (E, D, F) products on a dense dispatch buffer.

The reference pins logical shardings on the buffers (expert parallelism
over its model axis); on one card they are the identity and are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

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


def route(params, xt, cfg: ModelConfig, idx=None) -> Routing:
    """Top-k routing and capacity slots of the tokens ``xt`` (T, D).
    ``idx`` (T, k), when given, are the expert choices to take instead of
    the top k; their gates are still the router's probabilities."""
    T = xt.shape[0]
    E, K = cfg.moe_experts, cfg.moe_topk
    probs = _router_probs(params["router"], xt)
    if idx is None:
        gate, idx = torch.topk(probs, K, dim=-1)
    else:
        gate = probs.gather(-1, idx)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    cap = capacity(T, cfg)
    e_flat = idx.reshape(T * K)
    # rank each assignment within its expert (stable: earlier tokens win)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device))
    rank_sorted = torch.arange(T * K, device=xt.device) - start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, rank, cap - 1)
    return Routing(gate, idx, slot, keep, cap)


def moe_forward(params, x, cfg: ModelConfig, idx=None):
    """x: (B, S, D) -> (B, S, D); ``idx`` as in ``route`` (the expert
    choices of another pass, to compare two paths at the same routing)."""
    Bb, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = Bb * S
    xt = x.reshape(T, D)
    r = route(params, xt, cfg, idx)
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

    act = activation(cfg.act)
    up = torch.bmm(buf, params["wu"])
    if cfg.mlp_type == "gated":
        hidden = act(torch.bmm(buf, params["wg"])) * up
    else:
        hidden = act(up)
    out_buf = torch.bmm(hidden, params["wd"])

    gathered = torch.where(r.keep[:, None],
                           out_buf.reshape(E * r.cap, D).index_select(0, row),
                           0)
    # the weighted sum over k: bfloat16 products accumulated in float32
    # and rounded once, as the reference's jnp sum takes them
    y = (gathered.reshape(T, K, D)
         * r.gate.to(gathered.dtype)[..., None]).sum(dim=1)
    return y.reshape(Bb, S, D)


def moe_aux_loss(params, x, cfg: ModelConfig):
    """Load-balancing auxiliary loss (Switch-style): E times the sum over
    experts of the top-1 token fraction times the mean probability."""
    D = x.shape[-1]
    probs = _router_probs(params["router"], x.reshape(-1, D))
    _, idx = torch.topk(probs, cfg.moe_topk, dim=-1)
    onehot = F.one_hot(idx[:, 0], cfg.moe_experts).float()
    frac_tokens = onehot.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.moe_experts * torch.sum(frac_tokens * frac_probs)
