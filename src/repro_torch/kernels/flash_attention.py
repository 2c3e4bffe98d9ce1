"""Wrapper of the Hopper prefill attention kernel (`csrc/flash_attention.cu`).

`flash_attention_cuda` replaces the JAX package's Pallas kernel
`kernels/flash_attention.py:flash_attention`; its plain version is
`kernels/ref.py:flash_attention_ref`.  Inputs may be strided views
(the model passes its [B, L, H, hd] activations transposed), as long as
the head dim is contiguous; the output is a [B, H, Sq, hd] view of a
[B, Sq, H, hd] tensor, so the model's transpose back is free.  Keys may
be of another length than queries when the call is not causal (the
encoder-decoder's cross attention).  Launches are counted in
`.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_cuda"]

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def _head_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q, k, v, causal: bool = True):
    """q [B, H, Sq, hd]; k, v [B, KV, Sk, hd] on the card, float32 or
    bfloat16 alike -> [B, H, Sq, hd] in that dtype.  Sk >= 1 is any
    length when not causal (cross attention); causal needs Sk = Sq."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} must be a float32 or "
                            f"bfloat16 CUDA tensor, got {t.dtype} on "
                            f"{t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise TypeError("flash_attention: q, k and v must share dtype and "
                        "device")
    if KV == 0 or H % KV or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs H % KV == 0 and hd <= "
                         f"{MAX_HEAD_DIM}, got H={H}, KV={KV}, hd={hd}")
    if Sk == 0 or (causal and Sk != Sq):
        raise ValueError(f"flash_attention: {Sk} keys for {Sq} queries "
                         f"({'causal' if causal else 'non-causal'})")
    q, k, v = (_head_dim_contiguous(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    err = _build.load("flash_attention").flash_attention_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], hd ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_cuda.launches += 1
    _build.check(err, "flash_attention kernel")
    return out


flash_attention_cuda.launches = 0
