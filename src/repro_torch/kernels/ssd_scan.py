"""Wrapper of the Hopper SSD scan kernel (`csrc/ssd_scan.cu`).

`ssd_scan_cuda` replaces the JAX package's Pallas kernel
`src/repro/kernels/ssd_scan.py:80` (`ssd_scan`); its plain version is
`kernels/ref.py:ssd_scan_ref`, the chunked SSD of
`models/layers/ssd.py`.  Unlike the Pallas kernel it also returns the
final state, which the model's prefill stores in the decode cache, and
starts from an optional initial state.

What bounds it on the H100: operations.  The function is float32
arithmetic (the reference upcasts x, B and C), about 0.46 GFLOP for one
Mamba2-130M layer at L = 512 against ~4 MB of bytes; the kernel does it
on CUDA cores from shared memory, one CTA per (batch row, head, 16
columns of P) looping over chunks of 64 tokens with the state in shared
memory (the source's header says why 64 and not the model's 256).  Any
L.  Launches are counted in `.launches`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["ssd_scan_cuda"]

MAX_STATE = 256
DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_cuda(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None):
    """x [B, L, H, P], Bm / Cm [B, L, N] on the card, one dtype (float32 or
    bfloat16); dt [B, L, H] and A [H] (taken as float32); init_state
    [B, H, N, P] or None (zero) -> (y [B, L, H, P] in x's dtype, final
    state [B, H, N, P] float32)."""
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda" or t.dtype not in DTYPES:
            raise TypeError(f"ssd_scan: {name} must be a float32 or bfloat16 "
                            f"CUDA tensor, got {t.dtype} on {t.device}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssd_scan: x, Bm and Cm must share one dtype")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [B, L, H, P], got "
                         f"{tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if Bm.shape != (B, L, N) or Cm.shape != Bm.shape \
            or dt.shape != (B, L, H) or A.shape != (H,):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size N={N} not in 1..{MAX_STATE}")
    if init_state is not None and init_state.shape != (B, H, N, P):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)} "
                         f"is not {(B, H, N, P)}")
    for t in (dt, A) + (() if init_state is None else (init_state,)):
        if t.device != x.device:
            raise TypeError("ssd_scan: every input must be on x's device")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt, A = dt.float().contiguous(), A.float().contiguous()
    if init_state is not None:
        init_state = init_state.float().contiguous()
    y = torch.empty_like(x)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if B == 0 or H == 0 or P == 0:
        return y, final
    err = _build.load("ssd_scan").ssd_scan_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if init_state is None else init_state.data_ptr(), y.data_ptr(),
        final.data_ptr(), B, L, H, P, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    ssd_scan_cuda.launches += 1
    _build.check(err, "ssd_scan kernel")
    return y, final


ssd_scan_cuda.launches = 0
