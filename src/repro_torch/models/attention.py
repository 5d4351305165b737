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
                chunk_q: int = 512, chunk_k: int = 512):
    """Streaming-softmax attention, (B, Hq, Lq, D) x (B, Hkv, Lk, D).

    Every kv chunk is visited for every q chunk (the reference's schedule
    without ``causal_skip``, which only its training path uses); masked
    logits are -1e30 as in the reference.
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
        m = torch.full((B, Hkv, rep, cq), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, rep, cq), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, rep, cq, D), dtype=f32, device=dev)
        rows = off + qi * cq + torch.arange(cq, device=dev)[:, None]
        for kj in range(nk):
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
                      use_kernel: bool = False):
    """Full-sequence attention (train / prefill).  x: (B, L, D)."""
    if spmd.head_local(params):
        def shard(x, positions, qn, kn, wq, wk, wv, wo):
            return _attention({"wq": wq, "wk": wk, "wv": wv, "wo": wo,
                               "q_norm": qn, "k_norm": kn}, x, cfg,
                              positions, use_kernel)

        return spmd.shard_map(
            shard, (x, positions, spmd.local(params.get("q_norm")),
                    spmd.local(params.get("k_norm"))),
            tuple(params[k] for k in ("wq", "wk", "wv", "wo")), out="sum")
    return _attention(params, x, cfg, positions, use_kernel)


def _attention(params, x, cfg: ModelConfig, positions, use_kernel: bool):
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
        o = chunked_mha(q, k, v, causal=causal, window=cfg.window)
    return spmd.einsum("blhk,hkd->bld", o.transpose(1, 2), params["wo"],
                       _out_proj)


def attention_decode(params, x, cfg: ModelConfig, cache: KVCache):
    """One-token attention against the cache.  x: (B, 1, D).

    Unlike the reference, which returns new arrays, the new key and value
    are written into ``cache.k``/``cache.v`` in place (the returned cache
    shares their storage); only ``pos`` is a new tensor.
    """
    B = x.shape[0]
    W = cache.k.shape[2]
    q = _proj_heads(x, params["wq"])
    k_new = _proj_heads(x, params["wk"])
    v_new = _proj_heads(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, params["k_norm"], cfg.norm_eps)
    pos = cache.pos
    cos, sin = rope_freqs(pos[None].float(), cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k_new = apply_rope(k_new, cos[:, None], sin[:, None])

    # The reference's dynamic_update_slice clamps the slot into the cache.
    slot = pos % W if cfg.window is not None else torch.clamp(pos, max=W - 1)
    slot = slot.reshape(1).long()
    cache.k.index_copy_(2, slot, k_new.transpose(1, 2))
    cache.v.index_copy_(2, slot, v_new.transpose(1, 2))

    rep = cfg.num_heads // cfg.num_kv_heads
    qg = q.transpose(1, 2).reshape(B, cfg.num_kv_heads, rep, 1, cfg.hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(),
                     cache.k.float()) * (cfg.hd ** -0.5)
    idx = torch.arange(W, device=x.device)
    if cfg.window is None:
        valid = idx <= pos
    else:
        # rolling cache: slot s holds position pos - ((pos%W - s) mod W)
        age = torch.remainder(pos % W - idx, W)
        valid = age <= pos
    s = s.masked_fill(~valid.reshape(1, 1, 1, 1, W), _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(cache.v.dtype), cache.v)
    o = o.reshape(B, cfg.num_heads, 1, cfg.hd).transpose(1, 2)
    out = _out_proj(o, params["wo"])
    return out, KVCache(cache.k, cache.v, pos + 1)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None):
    W = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.num_kv_heads, W, cfg.hd)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
