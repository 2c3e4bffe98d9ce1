"""Wrapper of the Hopper decode attention kernel (`csrc/decode_attention.cu`).

`decode_attention_cuda` replaces the JAX package's Pallas kernel
`kernels/decode_attention.py:decode_attention`; its plain version is
`kernels/ref.py:decode_attention_ref`.  It reads the engine's KV cache
in place, in its [B, S, KV, hd] layout (the Pallas wrapper transposes
to [B, KV, S, hd] on every call).  Launches are counted in `.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["decode_attention_cuda"]

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """q [B, KV, G, hd]; caches [B, S, KV, hd]; lengths [B] (>= 1) on the
    card -> [B, KV, G, hd] in q's dtype.  q and the caches share one
    dtype, float32 or bfloat16."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda" or t.dtype not in DTYPES:
            raise TypeError(f"decode_attention: {name} must be a float32 "
                            f"or bfloat16 CUDA tensor, got {t.dtype} on "
                            f"{t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} must be 4-D with "
                             f"a contiguous head dim, got {tuple(t.shape)}")
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    if k_cache.shape != (B, S, KV, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} "
                         f"/ {tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype \
            or k_cache.device != q.device or v_cache.device != q.device:
        raise TypeError("decode_attention: q and the caches must share "
                        "dtype and device")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("decode_attention: lengths must be [B] on q's "
                         "device")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: hd={hd} > {MAX_HEAD_DIM}")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ni = 1 << max(0, (-(-hd // 32) - 1).bit_length())
    mg = min(8, 1 << (G - 1).bit_length())
    err = _build.load("decode_attention").decode_attention_launch(
        int(q.dtype == torch.bfloat16), ni, mg, q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, KV, G, hd, *q.stride()[:3],
        *k_cache.stride()[:3], *v_cache.stride()[:3], *out.stride()[:3],
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention_cuda.launches += 1
    _build.check(err, "decode_attention kernel")
    return out


decode_attention_cuda.launches = 0
