"""Wrapper of the Hopper decode attention kernel (`csrc/decode_attention.cu`).

`decode_attention_cuda` replaces the JAX package's Pallas kernel
`kernels/decode_attention.py:decode_attention`; its plain version is
`kernels/ref.py:decode_attention_ref`.  It reads the engine's KV cache
in place, in its [B, S, KV, hd] layout (the Pallas wrapper transposes
to [B, KV, S, hd] on every call), and splits the sequence across CTAs
by `split_plan`, which reads only shapes: the wrapper makes no host
sync and reads no device value, so a CUDA graph can capture it.
Launches are counted in `.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["decode_attention_cuda", "split_plan"]

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
# cache positions a CTA takes: SPLIT_MAX, halved down to SPLIT_MIN until
# the grid has a CTA for every SM; at most MAX_SPLITS splits (the
# kernel's shared-memory table of them)
SPLIT_MAX, SPLIT_MIN, MAX_SPLITS = 64, 16, 256
H100_SMS = 132

_TICKETS: dict = {}   # (device, stream) -> int32 counters, kept at zero


def split_plan(B: int, KV: int, S: int, n_gz: int = 1,
               n_sm: int = H100_SMS) -> tuple:
    """(split, n_splits) for a cache of capacity S: CTA s of a (batch
    row, KV head, query group) takes positions [s·split, (s+1)·split).
    The split is a power of two, as large as leaves B·KV·n_gz·n_splits
    >= n_sm (down to SPLIT_MIN), so the grid fills the card at B = 1;
    larger only where S would need more than MAX_SPLITS."""
    split = SPLIT_MAX
    while split > SPLIT_MIN and B * KV * n_gz * -(-S // split) < n_sm:
        split //= 2
    while -(-S // split) > MAX_SPLITS:
        split *= 2
    return split, max(1, -(-S // split))


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters for the merge tickets.  Every launch leaves
    its counters at zero, so one buffer serves all calls: it is made
    once per device and stream (launches on two streams never share a
    counter) and grown on demand, and no call allocates or clears one."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


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
    per_16b = 16 // q.element_size()
    lpr = max(4, 1 << (-(-hd // per_16b) - 1).bit_length())
    mg = min(8, 1 << (G - 1).bit_length())
    n_gz = -(-G // mg)
    split, n_splits = split_plan(
        B, KV, S, n_gz,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = torch.empty(B * KV * n_gz * n_splits * mg * (hd + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * KV * n_gz)
    err = _build.load("decode_attention").decode_attention_launch(
        int(q.dtype == torch.bfloat16), lpr, mg, q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, KV, G, hd,
        S, split, n_splits, *q.stride()[:3], *k_cache.stride()[:3],
        *v_cache.stride()[:3], *out.stride()[:3], hd ** -0.5, stream)
    decode_attention_cuda.launches += 1
    _build.check(err, "decode_attention kernel")
    return out


decode_attention_cuda.launches = 0
