"""Grouped-query attention: prefill (full-sequence causal) and decode
(one token against a KV cache), as the JAX package's
`models/layers/attention.py`.

Prefill (and training) attention goes through `kernels.ops.flash_attention`
(segment-masked on packed training batches) and decode
attention through `kernels.ops.decode_attention`: the Hopper kernels on
the card, their plain versions on the CPU (`impl="ref"` forces the
plain versions).  `naive_attention` is the test oracle only.  The
encoder-decoder's cross attention projects its queries from the decoder
(`cross_q`) and its keys and values from the encoder output
(`cross_kv`), without RoPE, as the JAX package's `models/encdec.py`
does inline.

Projection weights are the port's matrices, in the compute dtype:
wq [d, H·hd], wk / wv [d, KV·hd], wo [H·hd, d] (`convert.py` reshapes
the JAX layout).  The KV cache is [B, S_max, KV, hd]; `cache_update`
writes it in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels import ops
from ..module import ParamSpec
from .norms import rmsnorm, rmsnorm_spec
from .rope import apply_rope

NEG_INF = -1e30


def attention_specs(cfg) -> dict:
    """The JAX package's parameter specs (JAX layout)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), dt),
    }
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_spec(hd, "head_dim")
        specs["k_norm"] = rmsnorm_spec(hd, "head_dim")
    return specs


def qkv(p, x: torch.Tensor, cfg, cos, sin, rope_fn=apply_rope):
    """x [B, L, D] -> q [B, L, H, hd], k/v [B, L, KV, hd]: projections,
    qk-norm where the config has it, then RoPE on q and k."""
    B, L, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).view(B, L, cfg.n_heads, hd)
    k = (x @ p["wk"]).view(B, L, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).view(B, L, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return rope_fn(q, cos, sin), rope_fn(k, cos, sin), v


def naive_attention(q, k, v, causal: bool = True,
                    segment_ids=None) -> torch.Tensor:
    """O(L²)-memory oracle (tests only), the JAX package's arithmetic:
    f32 scores, softmax, probabilities cast to the input dtype before
    the product with v.  q [B, L, H, hd], k/v [B, L, KV, hd];
    `segment_ids` [B, L] masks keys of another segment."""
    B, L, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("blhk,bmhk->bhlm", q, k).float() * hd ** -0.5
    mask = None
    if causal:
        mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhk->blhk", probs, v)


def full_attention(q, k, v, causal: bool = True,
                   impl: Optional[str] = None,
                   segment_ids=None) -> torch.Tensor:
    """q [B, L, H, hd], k/v [B, F, KV, hd] -> [B, L, H, hd] through
    `ops.flash_attention` (K4), which reads and writes these layouts by
    strides: the transposes are views.  F = L when causal; not causal, F
    may differ (cross attention: the softmax over all F keys).
    `segment_ids` [B, L] (F = L) masks keys of another segment: the
    packed training batches of `data.packed_batches`."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, impl=impl,
                            segment_ids=segment_ids)
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, lengths,
                     impl: Optional[str] = None) -> torch.Tensor:
    """One-token decode: q [B, 1, H, hd] against caches [B, S, KV, hd];
    positions >= lengths[b] are masked.  Through `ops.decode_attention`
    (K5), which reads the cache in place."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    o = ops.decode_attention(q.reshape(B, KV, H // KV, hd), k_cache,
                             v_cache, lengths, impl=impl)
    return o.reshape(B, 1, H, hd)


def cross_q(p, h: torch.Tensor, cfg) -> torch.Tensor:
    """The cross attention's queries: h [B, L, D] -> [B, L, H, hd],
    `q_norm` where the config has qk-norm, no RoPE."""
    B, L, _ = h.shape
    q = (h @ p["wq"]).view(B, L, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def cross_kv(p, enc_out: torch.Tensor, cfg):
    """The cross attention's keys and values from the encoder output:
    enc_out [B, F, D] -> k, v [B, F, KV, hd], `k_norm` on k where the
    config has qk-norm, no RoPE."""
    B, F, _ = enc_out.shape
    k = (enc_out @ p["wk"]).view(B, F, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"]).view(B, F, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def out_proj(p, attn_out: torch.Tensor) -> torch.Tensor:
    B, L, H, hd = attn_out.shape
    return attn_out.reshape(B, L, H * hd) @ p["wo"]


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write the new K/V [B, 1, KV, hd] at position pos[b] of each row,
    in place (the JAX package returns updated copies; here the engine's
    cache is updated where it lies).  Returns the caches."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    pos = pos.to(k_cache.device).long()
    k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
