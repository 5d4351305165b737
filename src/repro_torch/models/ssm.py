"""Mamba2 (SSD) mixer -- built on the paper's affine scan.

The SSD recurrence h_t = exp(dt A) h_{t-1} + dt x_t (x) B_t is the paper's
trajectory recursion (eqs. 45-46) with a diagonal transition.  Two
execution paths for the full sequence:

* ``ssd_scan_chunked`` -- plain PyTorch in float32: per-chunk elements
  (decay, state increment) folded by an associative prefix scan
  (``repro_torch.core.pscan.prefix_scan``), the intra-chunk part dense
  (``repro_torch.kernels.ssd.ref``).  The reference's ``ServeEngine``
  runs this path.
* ``use_kernel=True`` -- ``ssd_trainable``: the CUDA chunked-SSD kernel
  (``repro_torch.kernels.ssd``) forward, as the reference swaps in its
  Pallas kernel on the accelerator, and the backward of
  ``ssd_scan_chunked``.  On CPU tensors the kernel wrapper runs its plain
  version.

Layer structure follows mamba2: in_proj -> [z | x | B | C | dt], short
depthwise conv on (x, B, C), SSD scan, gated RMSNorm, out_proj.  On
sharded weights (``repro_torch.distributed.spmd``) the split projections
and ``w_out`` go through ``spmd.einsum``; the fused ``w_in``, the conv
weights, ``A_log``, ``D_skip``, ``dt_bias`` and ``gate_norm`` are gathered
(``spmd.local``) and the scan runs at full width on the data group's home.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.kernels.ssd import ssd_scan_chunked, ssd_trainable

from .layers import P, rms_norm


def ssm_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    H = cfg.ssm_heads
    conv_dim = din + 2 * gs
    common = {
        "A_log": P((H,), ("ssm_heads",), init="ones"),
        "D_skip": P((H,), ("ssm_heads",), init="ones"),
        "dt_bias": P((H,), ("ssm_heads",), init="zeros"),
        "gate_norm": P((din,), ("ssm_inner",), init="ones"),
        "w_out": P((din, D), ("ssm_inner", "embed")),
    }
    if cfg.ssm_fused_proj:
        return {
            "w_in": P((D, 2 * din + 2 * gs + H), ("embed", "ssm_x")),
            "conv_w": P((cfg.ssm_conv, conv_dim), (None, "ssm_x"),
                        fan_in=cfg.ssm_conv),
            "conv_b": P((conv_dim,), ("ssm_x",), init="zeros"),
            **common,
        }
    return {
        "w_z": P((D, din), ("embed", "ssm_inner")),
        "w_x": P((D, din), ("embed", "ssm_inner")),
        "w_B": P((D, gs), ("embed", "ssm_x")),
        "w_C": P((D, gs), ("embed", "ssm_x")),
        "w_dt": P((D, H), ("embed", "ssm_heads")),
        "conv_x_w": P((cfg.ssm_conv, din), (None, "ssm_inner"),
                      fan_in=cfg.ssm_conv),
        "conv_x_b": P((din,), ("ssm_inner",), init="zeros"),
        "conv_B_w": P((cfg.ssm_conv, gs), (None, "ssm_x"),
                      fan_in=cfg.ssm_conv),
        "conv_B_b": P((gs,), ("ssm_x",), init="zeros"),
        "conv_C_w": P((cfg.ssm_conv, gs), (None, "ssm_x"),
                      fan_in=cfg.ssm_conv),
        "conv_C_b": P((gs,), ("ssm_x",), init="zeros"),
        **common,
    }


class SSMCache(NamedTuple):
    """Decode-time state: conv tail + SSD state (O(1) in context length)."""
    conv: torch.Tensor    # (B, conv_k - 1, conv_dim)
    state: torch.Tensor   # (B, H, P, S) float32


def _split_proj(cfg: ModelConfig, zxbcdt):
    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    H = cfg.ssm_heads
    return torch.split(zxbcdt, [din, din, gs, gs, H], dim=-1)


def _project_streams(params, x, cfg: ModelConfig):
    """in_proj + causal conv + silu -> (z, x, B, C, dt) streams."""
    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    w = {k: spmd.local(v) for k, v in params.items()
         if k.startswith("conv") or k == "w_in"}
    if cfg.ssm_fused_proj:
        zxbcdt = x @ w["w_in"]
        z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
        xbc = torch.cat([xs, Bm, Cm], dim=-1)
        xbc = F.silu(_causal_conv(xbc, w["conv_w"], w["conv_b"]))
        xs, Bm, Cm = torch.split(xbc, [din, gs, gs], dim=-1)
        return z, xs, Bm, Cm, dt
    z, xs, Bm, Cm, dt = (spmd.einsum("bld,dk->blk", x, params[k],
                                     torch.matmul)
                         for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))
    xs = F.silu(_causal_conv(xs, w["conv_x_w"], w["conv_x_b"]))
    Bm = F.silu(_causal_conv(Bm, w["conv_B_w"], w["conv_B_b"]))
    Cm = F.silu(_causal_conv(Cm, w["conv_C_w"], w["conv_C_b"]))
    return z, xs, Bm, Cm, dt


def ssm_forward(params, x, cfg: ModelConfig, *, use_kernel: bool = False):
    """Full-sequence mamba2 block.  x: (B, L, D) -> (B, L, D)."""
    Bb, L, _ = x.shape
    z, xs, Bm, Cm, dt = _project_streams(params, x, cfg)

    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    xh = xs.reshape(Bb, L, H, Pd)
    Bg = Bm.reshape(Bb, L, cfg.ssm_groups, cfg.ssm_state)
    Cg = Cm.reshape(Bb, L, cfg.ssm_groups, cfg.ssm_state)
    dth = F.softplus(dt + spmd.local(params["dt_bias"])[None, None])
    A = -torch.exp(spmd.local(params["A_log"]).float())
    D_skip = spmd.local(params["D_skip"])

    if use_kernel:
        y = ssd_trainable(xh, dth, A, Bg, Cg, D_skip, cfg.ssm_chunk)
    else:
        y = ssd_scan_chunked(xh, dth, A, Bg, Cg, D_skip, cfg.ssm_chunk)
    y = y.reshape(Bb, L, cfg.ssm_inner)
    y = rms_norm(y * F.silu(z), spmd.local(params["gate_norm"]),
                 cfg.norm_eps)
    return spmd.einsum("blk,kd->bld", y, params["w_out"], torch.matmul)


def preconv_streams(params, x, cfg: ModelConfig):
    """in_proj only (no conv/silu): (z, x, B, C, dt), each (B, L, *).  A
    sharded fused ``w_in`` is gathered; split projections go through
    ``spmd.einsum``."""
    if cfg.ssm_fused_proj:
        return _split_proj(cfg, x @ spmd.local(params["w_in"]))
    return tuple(spmd.einsum("bld,dk->blk", x, params[k], torch.matmul)
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def conv_cat_weights(params, cfg: ModelConfig):
    """(K, conv_dim) depthwise kernel over the concatenated (x, B, C)
    streams (decode-cache layout is stream-concatenated in both modes)."""
    w = {k: spmd.local(v) for k, v in params.items() if k.startswith("conv")}
    if cfg.ssm_fused_proj:
        return w["conv_w"], w["conv_b"]
    return (torch.cat([w["conv_x_w"], w["conv_B_w"], w["conv_C_w"]], dim=1),
            torch.cat([w["conv_x_b"], w["conv_B_b"], w["conv_C_b"]], dim=0))


def prefill_streams(params, x, cfg: ModelConfig) -> tuple:
    """What the decode caches take from a full sequence ``x`` (B, L, D):
    the conv tail (B, K - 1, conv_dim) of the pre-conv (x, B, C) streams;
    each head's weighted inputs ``w`` (B, L, H, P) float32, ``exp(sum of
    the later decays) dt x`` (the terminal SSD state is ``sum_l w B``);
    and ``B`` (B, L, G, S) float32."""
    Bb, L, _ = x.shape
    _, xs, Bm, Cm, dt = preconv_streams(params, x, cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    K = cfg.ssm_conv
    tail = (xbc[:, L - (K - 1):] if L >= K - 1
            else F.pad(xbc, (0, 0, K - 1 - L, 0)))
    w_cat, b_cat = conv_cat_weights(params, cfg)
    xbc_c = F.silu(_causal_conv(xbc, w_cat, b_cat))
    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    xs, Bm, Cm = torch.split(xbc_c, [din, gs, gs], dim=-1)
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    xh = xs.reshape(Bb, L, H, Pd).float()
    Bg = Bm.reshape(Bb, L, cfg.ssm_groups, cfg.ssm_state).float()
    dth = F.softplus(dt + spmd.local(params["dt_bias"])[None, None]).float()
    A = -torch.exp(spmd.local(params["A_log"]).float())
    # terminal state = sum_s exp(cumsum_rev) dt x B  (one associative pass)
    cum = torch.cumsum(dth * A[None, None], dim=1)
    wfin = torch.exp(cum[:, -1:] - cum)                       # (B, L, H)
    return tail, (wfin * dth)[..., None] * xh, Bg


def terminal_state(w, Bg, cfg: ModelConfig):
    """The SSD state (B, H, P, S) after the sequence of ``prefill_streams``'
    ``w`` and ``Bg``."""
    Bb, L, H, Pd = w.shape
    G = cfg.ssm_groups
    wg = w.reshape(Bb, L, G, H // G, Pd)
    state = torch.einsum("blgrp,blgs->bgrps", wg, Bg)
    return state.reshape(Bb, H, Pd, cfg.ssm_state)


def terminal_state_part(w, Bg, cfg: ModelConfig, heads: slice, p: slice,
                        device):
    """Heads ``heads`` and head-dim slice ``p`` of ``terminal_state``,
    computed on ``device`` from those heads' inputs and the B columns of
    their groups."""
    Bh = Bg.repeat_interleave(cfg.ssm_heads // cfg.ssm_groups, dim=2)
    return torch.einsum("blhp,blhs->bhps", w[:, :, heads, p].to(device),
                        Bh[:, :, heads].to(device))


def ssm_decode(params, x, cfg: ModelConfig, cache: SSMCache):
    """One-token mamba2 step.  x: (B, 1, D) -> (out (B, 1, D), new cache)."""
    Bb = x.shape[0]
    z, xs, Bm, Cm, dt = (a[:, 0] for a in preconv_streams(params, x, cfg))
    xbc = torch.cat([xs, Bm, Cm], dim=-1)             # (B, conv_dim)

    conv_hist = torch.cat([cache.conv, xbc[:, None]], dim=1)
    w, bconv = conv_cat_weights(params, cfg)           # (K, conv_dim)
    out = torch.einsum("bkc,kc->bc", conv_hist, w) + bconv
    xbc = F.silu(out)
    new_conv = conv_hist[:, 1:]

    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    xs, Bm, Cm = torch.split(xbc, [din, gs, gs], dim=-1)
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    rep = H // G
    xh = xs.reshape(Bb, H, Pd).float()
    Bg = Bm.reshape(Bb, G, S).float()
    Cg = Cm.reshape(Bb, G, S).float()
    dth = F.softplus(dt + params["dt_bias"][None]).float()
    A = -torch.exp(params["A_log"].float())

    state, y = _state_step(cache.state, xh, Bg, Cg, dth, A,
                           params["D_skip"].float(), rep)
    y = y.reshape(Bb, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    out = (y @ params["w_out"])[:, None]
    return out, SSMCache(new_conv, state)


def _state_step(state, xh, Bg, Cg, dth, A, D, rep: int):
    """One token's SSD update of ``state`` (B, H, P, S) and its output
    (B, H, P), float32."""
    a = torch.exp(dth * A[None])                       # (B, H)
    Bh = Bg.repeat_interleave(rep, dim=1) if rep > 1 else Bg   # (B, H, S)
    Ch = Cg.repeat_interleave(rep, dim=1) if rep > 1 else Cg
    state = (a[..., None, None] * state
             + (dth[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhps,bhs->bhp", state, Ch)
    return state, y + D[None, :, None] * xh


def ssm_decode_sharded(params, x, cfg: ModelConfig, conv_leaf, state_leaf,
                       layer: int, group, rows: slice):
    """One-token mamba2 step of one data group (``x``: (B_g, 1, D) on its
    home, ``params`` its views) against layer ``layer`` of the sharded
    stacked caches (``spmd.ShardedTensor``\\ s laid out by
    ``launch.steps.cache_layout``), ``rows`` its batch rows.

    The projections run on the home (``w_in`` gathered).  The conv tail
    split over channels: each model shard convolves its channels and
    writes its tail; the activations are all-gathered.  The state split
    over heads (or over the head dimension): each shard updates its part
    with its heads' inputs and their groups' B and C columns, and the
    outputs are all-gathered.  A replicated cache is stepped on the home's
    copy.  Every position that holds these rows gets the new tail and
    state, in place."""
    Bb = x.shape[0]
    z, xs, Bm, Cm, dt = (a[:, 0] for a in preconv_streams(params, x, cfg))
    xbc = torch.cat([xs, Bm, Cm], dim=-1)             # (B, conv_dim)
    w, bconv = conv_cat_weights(params, cfg)           # (K, conv_dim)
    layout = spmd.Layout(conv_leaf.mesh)
    devices = group.devices
    m = len(devices)

    def own(leaf, j):
        return leaf.shards[group.positions[j]][layer]

    if layout.cache_dim(conv_leaf) is None:
        hist = torch.cat([own(conv_leaf, 0), xbc[:, None]], dim=1)
        xbc = F.silu(torch.einsum("bkc,kc->bc", hist, w) + bconv)
        spmd.write_rows(conv_leaf, layer, rows, hist[:, 1:])
    else:                                              # over channels
        n = xbc.shape[-1] // m
        acts, tails = [], []
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                c = slice(j * n, (j + 1) * n)
                hist = torch.cat([own(conv_leaf, j), xbc[:, None, c].to(dev)],
                                 dim=1)
                acts.append(F.silu(torch.einsum(
                    "bkc,kc->bc", hist, w[:, c].to(dev)) + bconv[c].to(dev)))
                tails.append(hist[:, 1:])
        spmd.write_rows(conv_leaf, layer, rows, parts=tails)
        xbc = spmd.all_gather(acts, 1, group.home)

    din = cfg.ssm_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    xs, Bm, Cm = torch.split(xbc, [din, gs, gs], dim=-1)
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    rep = H // G
    xh = xs.reshape(Bb, H, Pd).float()
    Bg = Bm.reshape(Bb, G, S).float()
    Cg = Cm.reshape(Bb, G, S).float()
    dth = F.softplus(dt + spmd.local(params["dt_bias"])[None]).float()
    A = -torch.exp(spmd.local(params["A_log"]).float())
    D = spmd.local(params["D_skip"]).float()
    sdim = layout.cache_dim(state_leaf)                # 2: heads, 3: P
    if sdim is None:
        state, y = _state_step(own(state_leaf, 0), xh, Bg, Cg, dth, A, D, rep)
        spmd.write_rows(state_leaf, layer, rows, state)
    else:
        ys, states = [], []
        Bh, Ch = (g.repeat_interleave(rep, dim=1) for g in (Bg, Cg))
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                hs, ps = slice(None), slice(None)
                if sdim == 2:
                    hs = slice(j * H // m, (j + 1) * H // m)
                else:
                    ps = slice(j * Pd // m, (j + 1) * Pd // m)
                state, yj = _state_step(
                    own(state_leaf, j), xh[:, hs, ps].to(dev),
                    Bh[:, hs].to(dev), Ch[:, hs].to(dev),
                    dth[:, hs].to(dev), A[hs].to(dev), D[hs].to(dev), 1)
                states.append(state)
                ys.append(yj)
        spmd.write_rows(state_leaf, layer, rows, parts=states)
        y = spmd.all_gather(ys, sdim - 1, group.home)
    y = y.reshape(Bb, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), spmd.local(params["gate_norm"]), cfg.norm_eps)
    return spmd.einsum("blk,kd->bld", y[:, None], params["w_out"],
                       torch.matmul)


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, L, C); w: (K, C)."""
    K = w.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + L].float() * w[k]
    return (out + b).to(x.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=device))
