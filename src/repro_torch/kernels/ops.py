"""Dispatch between the Hopper kernels and their plain versions.

K1 `edge_rounds`, K2 `edge_rounds_bucketed` and K3 `simplex_project`
carry the sparse engine; K4 `flash_attention` and K5 `decode_attention`
carry the attention LM's prefill and decode (and the encoder-decoder's
encoder, decoder and cross attention); K6 `ssd_scan` carries the
Mamba2 mixer's prefill (its decode step is plain PyTorch: the JAX package
has no kernel for it); K7 `moe_gmm` carries the three expert products of
the MoE FFN, in prefill and decode alike.  Under autograd (training)
K4 and K7 run as `FlashAttentionFn` and `MoeGmmFn`: their forward
kernels, then K4's backward kernel (`flash_attention_bwd`) and two more
K7 launches (`moe_gmm_bwd`) in the backward pass.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain
PyTorch version (differentiable: on the CPU autograd takes its
gradient).  `impl="ref"` forces the plain version on any device
(the tests and `chip_smoke.py`'s comparisons use it).  There is no
fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .decode_attention import decode_attention_cuda
from .edge_rounds import edge_rounds_bucketed_cuda, edge_rounds_cuda
from .flash_attention import (FlashAttentionFn, flash_attention_bwd_cuda,
                              flash_attention_cuda)
from .moe_gmm import MoeGmmFn, moe_gmm_bwd_cuda, moe_gmm_cuda
from .simplex_project import simplex_project_cuda
from .ssd_scan import ssd_scan_cuda

# each wrapper counts its launches in `.launches`, by kernel name
_BY_NAME = {"edge_rounds": edge_rounds_cuda,
            "edge_rounds_bucketed": edge_rounds_bucketed_cuda,
            "simplex_project": simplex_project_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "decode_attention": decode_attention_cuda,
            "ssd_scan": ssd_scan_cuda, "moe_gmm": moe_gmm_cuda,
            "moe_gmm_bwd": moe_gmm_bwd_cuda}
KERNELS = tuple(_BY_NAME.values())


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in _BY_NAME.items()}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` × counts[name] to the counters.  A wrapper ticks when
    it is called, so while a CUDA graph is captured it ticks for launches
    that happen only at replay: a driver that replays a graph adds the
    captured counts once a replay and takes them back off the capture."""
    for name, n in counts.items():
        _BY_NAME[name].launches += times * n


def _pick(impl: Optional[str], t: torch.Tensor) -> str:
    if impl == "ref":
        return "ref"
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if t.device.type == "cuda":
        return "cuda"
    if impl == "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors")
    return "ref"


def edge_rounds(w_sp, inject, nbr, mask, reduce: str = "sum",
                shift: float = 0.0, max_rounds: Optional[int] = None,
                impl: Optional[str] = None, return_rounds: bool = False):
    """Sparse message-passing fixed point: w_sp [S, V, Dmax] edge
    weights, inject [S, V], padded neighbour tiles nbr/mask [V, Dmax].
    Masked weight slots are ignored, so slot garbage never propagates."""
    if w_sp.shape[-2:] != nbr.shape or nbr.shape != mask.shape:
        raise ValueError(
            f"edge weights {tuple(w_sp.shape)} are not aligned to the "
            f"neighbor tiles nbr{tuple(nbr.shape)}/mask{tuple(mask.shape)}; "
            "slot arrays must share the [V, Dmax] trailing layout of their "
            "Neighbors")
    if _pick(impl, w_sp) == "ref":
        x, k = _ref.edge_rounds_ref(w_sp, inject, nbr, mask, reduce=reduce,
                                    shift=shift, max_rounds=max_rounds)
    else:
        x, k = edge_rounds_cuda(w_sp, inject, nbr.to(torch.int32),
                                mask.view(torch.uint8), reduce=reduce,
                                shift=shift, max_rounds=max_rounds)
        k = int(k.max()) if return_rounds else k
    return (x, k) if return_rounds else x


def edge_rounds_bucketed(w_sp, inject, buckets, reduce: str = "sum",
                         shift: float = 0.0,
                         max_rounds: Optional[int] = None,
                         impl: Optional[str] = None,
                         return_rounds: bool = False):
    """`edge_rounds` over degree-bucketed tiles (`edge_rounds.EdgeBuckets`):
    the same fixed point, bitwise, at ΣVb·Db lanes a round.  w_sp is
    always the [S, V, Dmax] out-edge-slot weight array."""
    if w_sp.shape[-2] != buckets.nodes.shape[0]:
        raise ValueError(
            f"edge weights {tuple(w_sp.shape)} are not aligned to the bucket "
            f"tiles (V={buckets.nodes.shape[0]}); slot arrays must share the "
            "[V, Dmax] trailing layout of the Neighbors the buckets were "
            "built from")
    if _pick(impl, w_sp) == "ref":
        x, k = _ref.edge_rounds_bucketed_ref(
            w_sp, inject, buckets, reduce=reduce, shift=shift,
            max_rounds=max_rounds)
    else:
        x, k = edge_rounds_bucketed_cuda(w_sp, inject, buckets,
                                         reduce=reduce, shift=shift,
                                         max_rounds=max_rounds)
        k = int(k.max()) if return_rounds else k
    return (x, k) if return_rounds else x


def edge_rounds_stacked(problems, nbr, mask, reduce: str = "sum",
                        shift: float = 0.0, max_rounds: Optional[int] = None,
                        impl: Optional[str] = None, buckets=None):
    """Several `edge_rounds` problems over one neighbour tiling, solved
    in ONE launch by stacking them along the task axis.  Rounds past a
    sub-problem's exact fixed point reproduce it, so this equals solving
    them one by one."""
    w = torch.cat([w for w, _ in problems], dim=0)
    b = torch.cat([inj for _, inj in problems], dim=0)
    if buckets is not None:
        out = edge_rounds_bucketed(w, b, buckets, reduce=reduce, shift=shift,
                                   max_rounds=max_rounds, impl=impl)
    else:
        out = edge_rounds(w, b, nbr, mask, reduce=reduce, shift=shift,
                          max_rounds=max_rounds, impl=impl)
    return list(torch.split(out, [w.shape[0] for w, _ in problems], dim=0))


def simplex_project(phi, delta, M, permitted, impl: Optional[str] = None):
    """Batched Eq. 15 QP rows [R, K] (no lane padding on this card)."""
    if _pick(impl, phi) == "ref":
        return _ref.simplex_project_ref(phi, delta, M, permitted)
    return simplex_project_cuda(phi, delta, M, permitted)


def _grad_needed(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, causal: bool = True,
                    impl: Optional[str] = None, segment_ids=None):
    """GQA attention over a whole sequence: q [B, H, Sq, hd], k, v
    [B, KV, Sk, hd] -> [B, H, Sq, hd], any lengths (the prefill of `LM`
    and of `EncDecLM`'s encoder and decoder, and their training loss).
    Sk may differ from Sq only when not causal (the decoder's cross
    attention over the encoder frames); causal with Sk != Sq raises.
    `segment_ids` [B, Sq] masks keys of another segment (packed
    training batches).  On the card, when autograd needs its gradient,
    K4 runs as `FlashAttentionFn` (forward and backward kernels)."""
    if _pick(impl, q) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        segment_ids=segment_ids)
    if _grad_needed(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, segment_ids)
    return flash_attention_cuda(q, k, v, causal=causal,
                                segment_ids=segment_ids)


def decode_attention(q, k_cache, v_cache, lengths,
                     impl: Optional[str] = None):
    """One-token GQA attention: q [B, KV, G, hd] against caches in the
    engine's [B, S, KV, hd] layout, positions < lengths[b] (>= 1) valid
    -> [B, KV, G, hd]."""
    if _pick(impl, q) == "ref":
        return _ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    return decode_attention_cuda(q, k_cache, v_cache, lengths)


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, chunk: int = 256,
             impl: Optional[str] = None):
    """Mamba2 SSD scan: x [B, L, H, P], dt [B, L, H], A [H], Bm / Cm
    [B, L, N] -> (y [B, L, H, P], final state [B, H, N, P] float32).
    The caller's chunk contract holds on both routes: with chunk
    min(chunk, L), L must be a multiple of it (the JAX model path
    asserts the same), though the kernel itself takes any L."""
    L = x.shape[1]
    if L % min(chunk, L):
        raise AssertionError((L, chunk))
    if _pick(impl, x) == "ref":
        return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state=init_state,
                                 chunk=chunk)
    return ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=init_state)


def moe_gmm(x, w, impl: Optional[str] = None, active=None):
    """Grouped expert matmul: x [E, C, D] @ w [E, D, F] -> [E, C, F] in
    x's dtype, float32 sums over D; any E, C, D and F.  `active` ([E]
    bool or int32, on x's device) marks the experts that hold a row: the
    others' outputs are zero and their weights are not read.  On the
    card, when autograd needs its gradient, K7 runs as `MoeGmmFn`."""
    if _pick(impl, x) == "ref":
        return _ref.moe_gmm_ref(x, w, active)
    if _grad_needed(x, w):
        return MoeGmmFn.apply(x, w, active)
    return moe_gmm_cuda(x, w, active)
