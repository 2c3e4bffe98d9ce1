"""Wrappers of the Hopper prefill attention kernels: the forward
(`csrc/flash_attention.cu`) and the backward (`csrc/flash_attention_bwd.cu`).

`flash_attention_cuda` replaces the JAX package's Pallas kernel
`kernels/flash_attention.py:flash_attention`; its plain version is
`kernels/ref.py:flash_attention_ref`.  Inputs may be strided views
(the model passes its [B, L, H, hd] activations transposed), as long as
the head dim is contiguous; the output is a [B, H, Sq, hd] view of a
[B, Sq, H, hd] tensor, so the model's transpose back is free.  Keys may
be of another length than queries when the call is not causal (the
encoder-decoder's cross attention).  For training it also takes the
packed batch's segment ids and returns the rows' log-sum-exp.

`flash_attention_bwd_cuda` is its backward (the JAX package has no
backward kernel: it differentiates plain attention), three launches a
call: D = rowsum(dO ∘ O), then dK and dV a CTA per (batch row, KV head,
64 keys) summing over the group's query heads, then dQ a CTA per (batch
row, head, 64 queries); bfloat16 at hd 64 or 128 on the tensor cores
(`wgmma`, P and dS in three bfloat16 parts), everything else on CUDA
cores, as the forward picks.  Its plain version is the gradient of
`flash_attention_ref` under autograd.  `FlashAttentionFn` joins the two
under autograd.  Launches are counted in `.launches` of each wrapper.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["FlashAttentionFn", "flash_attention_bwd_cuda",
           "flash_attention_cuda"]

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def _head_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_qkv(q, k, v, causal, segment_ids):
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
    if Sk == 0 or ((causal or segment_ids is not None) and Sk != Sq):
        raise ValueError(f"flash_attention: {Sk} keys for {Sq} queries "
                         f"({'causal' if causal else 'non-causal'}"
                         f"{', segments' if segment_ids is not None else ''})")
    if segment_ids is None:
        return None
    if segment_ids.shape != (B, Sq) or segment_ids.device != q.device:
        raise ValueError(f"flash_attention: segment_ids must be [{B}, {Sq}] "
                         f"on {q.device}, got {tuple(segment_ids.shape)} on "
                         f"{segment_ids.device}")
    return segment_ids.to(torch.int32).contiguous()


def flash_attention_cuda(q, k, v, causal: bool = True, segment_ids=None,
                         return_lse: bool = False):
    """q [B, H, Sq, hd]; k, v [B, KV, Sk, hd] on the card, float32 or
    bfloat16 alike -> [B, H, Sq, hd] in that dtype.  Sk >= 1 is any
    length when not causal (cross attention); causal needs Sk = Sq.
    `segment_ids` [B, Sq] (Sk = Sq) masks the keys of other segments
    than the query's; every row must keep a key (causal: its own).  With
    `return_lse` -> (out, the rows' log-sum-exp of the scaled scores
    [B, H, Sq] float32 (natural log), the output in float32 [B, H, Sq,
    hd] (for bfloat16 the output before its cast; for float32 `out`
    itself)): what the backward takes."""
    seg = _check_qkv(q, k, v, causal, segment_ids)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    q, k, v = (_head_dim_contiguous(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = o32 = None
    if return_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        o32 = (out if q.dtype == torch.float32 else
               torch.empty((B, H, Sq, hd), dtype=torch.float32,
                           device=q.device))
    if out.numel() == 0:
        return (out, lse, o32) if return_lse else out
    lib = _build.load("flash_attention")
    args = (int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], hd ** -0.5, int(bool(causal)))
    err = lib.flash_attention_fwd_launch(
        *args, None if seg is None else seg.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if o32 is None or o32 is out else o32.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_cuda.launches += 1
    _build.check(err, "flash_attention kernel")
    return (out, lse, o32) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(do, q, k, v, out, lse, causal: bool = True,
                             segment_ids=None):
    """The gradient of `flash_attention_cuda(q, k, v, causal,
    segment_ids)` given its float32 output `out` and its log-sum-exp
    `lse` ([B, H, Sq] float32; both from `return_lse=True`: D from a
    bfloat16 output would be off by its rounding) and the output's
    gradient `do` ([B, H, Sq, hd], any strides with the head dim
    contiguous) -> (dq, dk, dv), each in its input's dtype and shape
    ([B, H, Sq, hd] views of [B, Sq, H, hd] tensors, dk / dv likewise).
    Sums in float32; no atomics, so a call repeats bit for bit."""
    seg = _check_qkv(q, k, v, causal, segment_ids)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if do.shape != q.shape or out.shape != q.shape or do.dtype != q.dtype \
            or out.dtype != torch.float32:
        raise ValueError("flash_attention backward: do must match q, out "
                         "must be q's shape in float32")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be [{B}, {H}, "
                         f"{Sq}] float32")
    q, k, v, do, out = (_head_dim_contiguous(t) for t in (q, k, v, do, out))
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((B, Sk, KV, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention_bwd").flash_attention_bwd_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        None if seg is None else seg.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Sk,
        hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], hd ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_bwd_cuda.launches += 1
    _build.check(err, "flash_attention backward kernel")
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K4 under autograd: the forward kernel (saving its float32 output
    and log-sum-exp), the backward kernel for dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids):
        out, lse, o32 = flash_attention_cuda(q, k, v, causal, segment_ids,
                                             return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o32, lse, segment_ids)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(do, q, k, v, o32, lse,
                                              ctx.causal, seg)
        return dq, dk, dv, None, None
