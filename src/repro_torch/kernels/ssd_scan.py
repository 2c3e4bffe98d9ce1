"""Wrapper of the Hopper SSD scan kernel (`csrc/ssd_scan.cu`).

`ssd_scan_cuda` replaces the JAX package's Pallas kernel
`src/repro/kernels/ssd_scan.py:80` (`ssd_scan`); its plain version is
`kernels/ref.py:ssd_scan_ref`, the chunked SSD of
`models/layers/ssd.py`.  Unlike the Pallas kernel it also returns the
final state, which the model's prefill stores in the decode cache, and
starts from an optional initial state.

What bounds it on the H100: about 0.46 GFLOP for one Mamba2-130M layer
at L = 512 against ~4 MB of bytes, so operations in float32 (CUDA cores)
and bytes in bf16 (tensor cores); at the model's sizes latency sets the
time.  One call is three launches
(the source's header has the design): the chunk-local states, the
hand-off of the state from chunk to chunk, and the output, each CTA of
the first and last taking one (batch row, chunk of 64 tokens, group of
`ssd_plan(...).heads` heads, 64 columns of P).  bf16 runs its products
on tensor cores, float32 on CUDA cores.  Any L (at L = 0 only the
hand-off runs, writing the initial state or zero as the final state).
Wrapper calls are counted in `.launches` (three kernel launches each).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

__all__ = ["ssd_scan_cuda", "ssd_plan", "SSDPlan"]

MAX_STATE = 256
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64            # csrc/ssd_scan.cu kQ: the kernel's own chunk
P_BLOCK = 64          # kPB: columns of P a CTA takes
MAX_HEADS = 4         # kMaxHeads: heads a CTA
SMEM_LIMIT = 232448   # dynamic shared memory a CTA may have on an H100
H100_SMS = 132
KERNEL_LAUNCHES = 3   # states, hand-off, output


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(kernel: str, bf16: bool, N: int, heads: int) -> int:
    """Dynamic shared memory of one CTA of `kernel` ("states" or
    "output"), as `Layout` in the source lays it out."""
    e = 2 if bf16 else 4
    np_ = _ceil(N, 16) * 16
    bc = e * CHUNK * (np_ + 16 // e)          # a B or C tile
    xt = e * CHUNK * (P_BLOCK + 16 // e)      # an x (or z⊙x) tile
    if kernel == "states":
        return bc + heads * xt + (2 * xt if bf16 else 0) + 4 * heads * CHUNK
    s = (2 if bf16 else 1) * e * np_ * (P_BLOCK + 16 // e)
    w = 0 if bf16 else 4 * CHUNK * (CHUNK + 1)
    return bc + max(bc, s) + heads * xt + w + 8 * heads * CHUNK


@dataclass(frozen=True)
class SSDPlan:
    """The launch plan of one call: CTA (c, g · p_blocks + pb, b) of the
    states and output kernels takes chunk c (tokens [64 c, 64 c + 64)),
    heads [g · heads, min(H, (g + 1) · heads)) and columns
    [64 pb, 64 pb + 64) of batch row b."""
    chunks: int
    groups: int
    heads: int
    p_blocks: int
    n_pad: int
    smem_states: int
    smem_output: int

    def grid(self, B: int) -> tuple:
        return (self.chunks, self.groups * self.p_blocks, B)

    def scratch_floats(self, B: int, H: int) -> int:
        """float32 words of one chunk-state buffer (and of the buffer of
        entering states): a [n_pad, 64] block a (b, chunk, head, P
        block)."""
        return B * self.chunks * H * self.p_blocks * self.n_pad * P_BLOCK


def ssd_plan(B: int, L: int, H: int, P: int, N: int, bf16: bool,
             n_sm: int = H100_SMS) -> SSDPlan:
    """Heads a CTA: the fewest (1..MAX_HEADS) that keep the grid within
    one CTA an SM, so that C Bᵀ is shared across heads where the card
    has fewer SMs than (chunk, head) pairs and every head has a CTA of
    its own where it has more; fewer where shared memory is short."""
    chunks, p_blocks = _ceil(L, CHUNK), _ceil(P, P_BLOCK)
    units = max(B * chunks * p_blocks, 1)
    heads = min(MAX_HEADS, H, max(1, _ceil(H * units, n_sm)))
    while heads > 1 and max(smem_bytes(k, bf16, N, heads)
                            for k in ("states", "output")) > SMEM_LIMIT:
        heads -= 1
    return SSDPlan(chunks=chunks, groups=_ceil(H, heads), heads=heads,
                   p_blocks=p_blocks, n_pad=_ceil(N, 16) * 16,
                   smem_states=smem_bytes("states", bf16, N, heads),
                   smem_output=smem_bytes("output", bf16, N, heads))


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
    bf16 = x.dtype == torch.bfloat16
    plan = ssd_plan(B, L, H, P, N, bf16)
    n = plan.scratch_floats(B, H)
    # chunk states, entering states (16-byte aligned: n is a multiple
    # of 1024), then each (b, chunk, head)'s total
    work = torch.empty(2 * n + B * plan.chunks * H, dtype=torch.float32,
                       device=x.device)
    base = work.data_ptr()
    err = _build.load("ssd_scan").ssd_scan_chunks_launch(
        int(bf16), x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), base, base + 4 * n, base + 8 * n,
        B, L, H, P, N, plan.heads,
        torch.cuda.current_stream(x.device).cuda_stream)
    ssd_scan_cuda.launches += 1
    _build.check(err, "ssd_scan kernels")
    return y, final


ssd_scan_cuda.launches = 0
