"""Attention mixer: GQA, RoPE, qk-norm, sliding window.

Two execution paths for the full sequence (train / prefill):

* ``chunked_mha`` -- streaming-softmax attention in plain PyTorch (a loop
  over q chunks and kv chunks).  Never materialises the (L, L) logits.
  The reference's ``ServeEngine`` runs this path.
* ``use_kernel=True`` -- ``attention_trainable``: the CUDA flash-attention
  kernel (``repro_torch.kernels.flash_attention``) forward, as the
  reference swaps in its Pallas kernel on the accelerator, and the
  backward of the plain ``mha_ref``.  On CPU tensors the kernel wrapper
  runs its plain version.

The decode path is single-token attention against a (possibly rolling)
KV cache; O(L) work, no chunking.  GQA is computed without repeating K/V:
q is reshaped to (B, Hkv, rep, L, D) and contracted group-wise.

On sharded weights (``repro_torch.distributed.spmd``) the projections go
through ``spmd.einsum``; where ``wq`` is split on ``heads`` and ``wk``/``wv``
on ``kv_heads``, attention runs per model shard on its heads (the kernel
at H/m and Hkv/m heads) and the shards' ``wo`` products are summed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.kernels.flash_attention import attention_trainable

from .layers import P, apply_rope, rms_norm, rope_freqs

_NEG = -1e30


def attn_spec(cfg: ModelConfig) -> dict:
    D, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kv_tail = None if cfg.kv_replicate else "head"
    spec = {
        "wq": P((D, Hq, hd), ("embed", "heads", "head")),
        "wk": P((D, Hkv, hd), ("embed", "kv_heads", kv_tail)),
        "wv": P((D, Hkv, hd), ("embed", "kv_heads", kv_tail)),
        "wo": P((Hq, hd, D), ("heads", "head", "embed"), fan_in=Hq * hd),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((hd,), ("head",), init="ones")
        spec["k_norm"] = P((hd,), ("head",), init="ones")
    return spec


class KVCache(NamedTuple):
    """Dense or rolling-window KV cache.

    k, v: (B, Hkv, W, hd) where W = window or max context (a leading
    layers axis when stacked); ``pos`` (int32, 0-d or per layer) is the
    number of tokens already absorbed, the same for every batch row.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def _proj_heads(x, w):
    """(B, L, D) x (D, H, hd) -> (B, L, H, hd)."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _out_proj(o, wo):
    """(B, L, Hq, hd) x (Hq, hd, D) -> (B, L, D)."""
    Hq, hd, D = wo.shape
    return o.reshape(*o.shape[:-2], Hq * hd) @ wo.reshape(Hq * hd, D)


def chunked_mha(q, k, v, *, causal: bool, window: Optional[int],
                chunk_q: int = 512, chunk_k: int = 512,
                causal_skip: bool = False):
    """Streaming-softmax attention, (B, Hq, Lq, D) x (B, Hkv, Lk, D).

    Every kv chunk is visited for every q chunk, unless ``causal_skip``
    (with ``causal``): then q chunk ``qi`` visits kv chunks ``0 .. hi - 1``
    only, the reference's bound ``hi = (off + (qi + 1) cq + ck - 1) // ck``
    (``lo`` stays 0 even with a window, as there).  The chunks skipped are
    wholly masked and come after a visible one, so the output is the same
    bit for bit; the products executed drop to the causal band.  Masked
    logits are -1e30 as in the reference.

    On ``meta`` tensors (the dry-run: shapes only) each q chunk takes its
    kv chunks in one product of the same size, so the loop costs one step
    per q chunk instead of one per chunk pair.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = D ** -0.5
    cq = min(chunk_q, Lq)
    ck = min(chunk_k, Lk)
    if Lq % cq or Lk % ck:
        raise ValueError(f"chunked_mha needs Lq % {cq} == 0 and Lk % {ck} "
                         f"== 0, got Lq={Lq}, Lk={Lk}")
    nq, nk = Lq // cq, Lk // ck
    off = Lk - Lq  # q rows aligned to the end of the keys
    f32 = torch.float32
    dev = q.device

    qg = q.reshape(B, Hkv, rep, Lq, D)
    blocks = []
    for qi in range(nq):
        qc = qg[:, :, :, qi * cq:(qi + 1) * cq]
        hi = nk
        if causal and causal_skip:
            hi = min(nk, (off + (qi + 1) * cq + ck - 1) // ck)
        if dev.type == "meta":
            s = torch.einsum("bgrqd,bgkd->bgrqk", qc.float(),
                             k[:, :, :hi * ck].float())
            out = torch.einsum("bgrqk,bgkd->bgrqd", s,
                               v[:, :, :hi * ck].float())
            blocks.append(out.to(q.dtype))
            continue
        m = torch.full((B, Hkv, rep, cq), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, rep, cq), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, rep, cq, D), dtype=f32, device=dev)
        rows = off + qi * cq + torch.arange(cq, device=dev)[:, None]
        for kj in range(hi):
            kc = k[:, :, kj * ck:(kj + 1) * ck]
            vc = v[:, :, kj * ck:(kj + 1) * ck]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qc.float(),
                             kc.float()) * scale
            cols = kj * ck + torch.arange(ck, device=dev)[None, :]
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= rows >= cols
            if window is not None:
                mask &= (rows - cols) < window
            s = s.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=3).reshape(B, Hq, Lq, D)


def attention_forward(params, x, cfg: ModelConfig, positions, *,
                      use_kernel: bool = False, causal_skip: bool = False):
    """Full-sequence attention (train / prefill).  x: (B, L, D).
    ``causal_skip`` selects ``chunked_mha``'s triangular schedule (the
    kernel path takes no such flag, as in the reference)."""
    if spmd.head_local(params):
        def shard(x, positions, qn, kn, wq, wk, wv, wo):
            return _attention({"wq": wq, "wk": wk, "wv": wv, "wo": wo,
                               "q_norm": qn, "k_norm": kn}, x, cfg,
                              positions, use_kernel, causal_skip)

        return spmd.shard_map(
            shard, (x, positions, spmd.local(params.get("q_norm")),
                    spmd.local(params.get("k_norm"))),
            tuple(params[k] for k in ("wq", "wk", "wv", "wo")), out="sum")
    return _attention(params, x, cfg, positions, use_kernel, causal_skip)


def _attention(params, x, cfg: ModelConfig, positions, use_kernel: bool,
               causal_skip: bool = False):
    q = spmd.einsum("bld,dhk->blhk", x, params["wq"], _proj_heads)
    k = spmd.einsum("bld,dhk->blhk", x, params["wk"], _proj_heads)
    v = spmd.einsum("bld,dhk->blhk", x, params["wv"], _proj_heads)
    if cfg.qk_norm:
        q = rms_norm(q, spmd.local(params["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, spmd.local(params["k_norm"]), cfg.norm_eps)
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k = apply_rope(k, cos[:, None], sin[:, None])
    q, k, v = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    causal = cfg.causal and not cfg.is_encoder
    if use_kernel:
        o = attention_trainable(q, k, v, causal, cfg.window)
    else:
        o = chunked_mha(q, k, v, causal=causal, window=cfg.window,
                        causal_skip=causal_skip)
    return spmd.einsum("blhk,hkd->bld", o.transpose(1, 2), params["wo"],
                       _out_proj)


def attention_decode(params, x, cfg: ModelConfig, cache: KVCache):
    """One-token attention against the cache.  x: (B, 1, D).

    Unlike the reference, which returns new arrays, the new key and value
    are written into ``cache.k``/``cache.v`` in place (the returned cache
    shares their storage); only ``pos`` is a new tensor.
    """
    q, k_new, v_new = _decode_qkv(params, x, cfg, cache.pos)
    slot = _slot(cfg, cache.pos, cache.k.shape[2])
    cache.k.index_copy_(2, slot, k_new.transpose(1, 2))
    cache.v.index_copy_(2, slot, v_new.transpose(1, 2))
    o = _attend(q, cache.k, cache.v, cfg, cache.pos)
    return _out_proj(o, params["wo"]), KVCache(cache.k, cache.v, cache.pos + 1)


def _decode_qkv(params, x, cfg: ModelConfig, pos):
    """The new token's q, k and v (B, 1, H, hd), normed and rope'd at full
    ``hd`` (on a :class:`~spmd.Shards` weight: all-gathered)."""
    q = spmd.einsum("bld,dhk->blhk", x, params["wq"], _proj_heads)
    k = spmd.einsum("bld,dhk->blhk", x, params["wk"], _proj_heads)
    v = spmd.einsum("bld,dhk->blhk", x, params["wv"], _proj_heads)
    if cfg.qk_norm:
        q = rms_norm(q, spmd.local(params["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, spmd.local(params["k_norm"]), cfg.norm_eps)
    cos, sin = rope_freqs(pos[None].float(), cfg.hd, cfg.rope_theta)
    return (apply_rope(q, cos[:, None], sin[:, None]),
            apply_rope(k, cos[:, None], sin[:, None]), v)


def _slot(cfg: ModelConfig, pos, W: int):
    # The reference's dynamic_update_slice clamps the slot into the cache.
    slot = pos % W if cfg.window is not None else torch.clamp(pos, max=W - 1)
    return slot.reshape(1).long()


def _masked(s, cfg: ModelConfig, pos):
    """Scores ``s`` (..., W) with the slots not yet written set to -1e30."""
    W = s.shape[-1]
    idx = torch.arange(W, device=s.device)
    if cfg.window is None:
        valid = idx <= pos
    else:
        # rolling cache: slot s holds position pos - ((pos%W - s) mod W)
        valid = torch.remainder(pos % W - idx, W) <= pos
    return s.masked_fill(~valid, _NEG)


def _attend(q, K, V, cfg: ModelConfig, pos):
    """The new token's q (B, 1, H, d) against a cache's K/V (B, g, W, d),
    H = g x rep query heads: the output (B, 1, H, d)."""
    B, _, H, d = q.shape
    g = K.shape[1]
    qg = q.transpose(1, 2).reshape(B, g, H // g, 1, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(),
                     K.float()) * (cfg.hd ** -0.5)
    p = torch.softmax(_masked(s, cfg, pos), dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(V.dtype), V)
    return o.reshape(B, H, 1, d).transpose(1, 2)


def attention_decode_sharded(params, x, cfg: ModelConfig, k_leaf, v_leaf,
                             pos, layer: int, group, rows: slice):
    """One-token attention of one data group (``x``: (B_g, 1, D) on its
    home, ``params`` its views) against layer ``layer`` of the sharded
    stacked caches ``k_leaf``/``v_leaf`` (``spmd.ShardedTensor``\\ s laid
    out by ``launch.steps.cache_layout``), ``rows`` its batch rows.

    * kv split over kv heads: each model shard scores its own heads against
      its cache shard (with head-local weights, from its own projections).
    * kv split over ``hd``: the new key is rope'd at full ``hd`` on the
      home, then sliced; each shard's scores are a partial sum over its
      ``hd`` slice, reduced with one all-reduce before the softmax; each
      shard's output is its ``hd`` slice.
    * kv replicated: as ``attention_decode``, on the home's copy.

    The shards' partial ``wo`` products are all-reduced where ``wo`` splits
    as the outputs do (heads, or ``head``), else the outputs are
    all-gathered and projected on the home.  The new key and value are
    written at their slot into the shard of every position that holds
    these rows (the group's own and its replicas), in place."""
    B = x.shape[0]
    kdim = spmd.Layout(k_leaf.mesh).cache_dim(k_leaf)   # 2: kv heads, 4: hd
    holders = spmd.holders(k_leaf, rows)
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    slot = _slot(cfg, pos, k_leaf.shape[3])
    wo = params["wo"]
    devices = group.devices
    m = len(devices)

    def write(j, kn, vn):
        for p, i in holders:
            if kdim is None or i == j:
                for leaf, new in ((k_leaf, kn), (v_leaf, vn)):
                    dst = leaf.shards[p][layer]
                    dst.index_copy_(2, slot.to(dst.device),
                                    new.transpose(1, 2).to(dst.device))

    def own(leaf, j):
        return leaf.shards[group.positions[j]][layer]

    if kdim is None:
        q, kn, vn = _decode_qkv(params, x, cfg, pos)
        write(0, kn, vn)
        o = _attend(q, own(k_leaf, 0), own(v_leaf, 0), cfg, pos)
        return spmd.einsum("blhk,hkd->bld", o, wo, _out_proj)

    if kdim == 2 and spmd.head_local(params):
        qkv = []
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                w = {k: params[k].parts[j] for k in ("wq", "wk", "wv")}
                for k in ("q_norm", "k_norm"):
                    w[k] = spmd.local(params.get(k))
                    w[k] = None if w[k] is None else w[k].to(dev)
                qkv.append(_decode_qkv(w, x.to(dev), cfg, pos.to(dev)))
    else:
        q, kn, vn = _decode_qkv(params, x, cfg, pos)
        d = 2 if kdim == 2 else 3
        n, nkv = ((Hq // m, Hkv // m) if kdim == 2 else (hd // m, hd // m))
        qkv = [(q.narrow(d, j * n, n).to(dev), kn.narrow(d, j * nkv, nkv)
                .to(dev), vn.narrow(d, j * nkv, nkv).to(dev))
               for j, dev in enumerate(devices)]
    outs = []
    if kdim == 2:
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                qj, knj, vnj = qkv[j]
                write(j, knj, vnj)
                outs.append(_attend(qj, own(k_leaf, j), own(v_leaf, j), cfg,
                                    pos.to(dev)))
    else:
        parts = []
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                qj, knj, vnj = qkv[j]
                write(j, knj, vnj)
                qg = qj.transpose(1, 2).reshape(B, Hkv, Hq // Hkv, 1, -1)
                parts.append(torch.einsum("bgrqd,bgkd->bgrqk", qg.float(),
                                          own(k_leaf, j).float()))
        # the hd shards' partial scores, summed before the softmax
        s = spmd.all_reduce(parts, group.home) * (hd ** -0.5)
        p = torch.softmax(_masked(s, cfg, pos), dim=-1)
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                V = own(v_leaf, j)
                o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(dev).to(V.dtype), V)
                outs.append(o.reshape(B, Hq, 1, -1).transpose(1, 2))
    od = 2 if kdim == 2 else 3                    # o: (B, 1, H, hd)
    if isinstance(wo, spmd.Shards) and wo.dim == od - 2:
        partial = []
        for j, dev in enumerate(devices):
            with spmd.on_shard(j, dev):
                partial.append(_out_proj(outs[j], wo.parts[j]))
        return spmd.all_reduce(partial, group.home)
    return spmd.einsum("blhk,hkd->bld", spmd.all_gather(outs, od, group.home),
                       wo, _out_proj)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None):
    W = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.num_kv_heads, W, cfg.hd)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
