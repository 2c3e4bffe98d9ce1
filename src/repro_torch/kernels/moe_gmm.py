"""Wrapper of the Hopper grouped matmul kernel (`csrc/moe_gmm.cu`).

`moe_gmm_cuda` replaces the JAX package's Pallas kernel
`src/repro/kernels/moe_gmm.py:35` (`moe_gmm`); its plain version is
`kernels/ref.py:moe_gmm_ref`.  It takes any E, C, D and F (the Pallas
kernel asserts multiples of its tiles): the MoE layer's capacity C is
ragged (52 at a 333-token prompt).

What bounds it on the H100: bytes.  One launch reads one layer's expert
weight (268 MB in bf16 at OLMoE's 64 x 2048 x 1024) against at most
21.5 GFLOP, so the kernel streams each tile of w once through a deep
cp.async ring on a persistent grid, two or three CTAs an SM, that deals the
(expert, 128 rows, 64 or 128 columns) tiles of the active experts out in
turn (`tile_schedule`); bfloat16 multiplies on the tensor cores, float32 on
CUDA cores (the source's header says why).  `active` marks the experts
that hold a row: the kernel reads it on the device, zeroes the others'
outputs and reads none of their weight.  Launches are counted in
`.launches`.

Under autograd (`MoeGmmFn`) the backward is one launch of its own kernel
(`moe_gmm_bwd_cuda`, `csrc/moe_gmm_bwd.cu`) for bfloat16 with D and F
multiples of 8 and 16-byte aligned operands: dx = dy·wᵀ and dw = xᵀ·dy
on the tensor cores, dy, x and w read where they lie, the (dx, dw) tiles
of the active experts dealt over one persistent grid
(`bwd_tile_schedule`).  Float32 (the parity checks) and unaligned
bfloat16 take two launches of the forward kernel instead, dx = K7(dy,
wᵀ) and dw = K7(xᵀ, dy), on contiguous copies of xᵀ [E, D, C] and wᵀ
[E, F, D]; no library matmul.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["MoeGmmFn", "bwd_tile_schedule", "moe_gmm_bwd_cuda",
           "moe_gmm_cuda", "tile_schedule", "tile_width"]

DTYPES = (torch.float32, torch.bfloat16)
MAX_M = 128                  # rows of one tile (csrc kMaxM)
BWD_TILE = (128, 256)        # rows, columns of a backward tile (kBM, kBN)


def tile_width(C: int, tensor_cores: bool) -> int:
    """Columns of one tile: the tensor-core kernel's 64 at C <= 16 (the
    decode step) and 128 above; the CUDA-core kernel's 64."""
    return 128 if tensor_cores and C > 16 else 64
_ACTIVE_BYTES = {torch.bool: 1, torch.int32: 4}


def tile_schedule(E, C, F, active, ctas, bn=64):
    """The kernel's schedule: for each CTA of a persistent grid of
    `ctas`, the (expert, first row, first column) tiles it sums, in
    order.  The tiles of the active experts (all when `active` is None),
    expert-major, then 128-row block, then `bn`-column block
    (`tile_width`); CTA b takes tiles b, b + G, b + 2G, ..., so no two
    CTAs differ by more than one tile and the CTAs side by side read one
    expert's columns together."""
    experts = [e for e in range(E) if active is None or active[e]]
    n_mb, n_nb = -(-C // MAX_M), -(-F // bn)
    tiles = [(e, mb * MAX_M, nb * bn) for e in experts
             for mb in range(n_mb) for nb in range(n_nb)]
    return [tiles[b::ctas] for b in range(ctas)]


def bwd_tile_schedule(E, C, D, F, active, ctas, need_dx=True,
                      need_dw=True):
    """The backward kernel's schedule: for each CTA of a persistent grid
    of `ctas`, the ("dx" | "dw", expert, first row, first column) tiles
    of 128 x 256 outputs it sums, in order.  The dx tiles of the active
    experts (all when `active` is None; expert-major, then 128-row block
    of C, then 256-column block of D), then their dw tiles (128-row block
    of D, then 256-column block of F); `need_dx` / `need_dw` leave one
    kind out.  CTA b takes tiles b, b + G, b + 2G, ..., so no two CTAs
    differ by more than one tile."""
    experts = [e for e in range(E) if active is None or active[e]]
    bm, bn = BWD_TILE
    tiles = []
    if need_dx:
        tiles += [("dx", e, r, n) for e in experts for r in range(0, C, bm)
                  for n in range(0, D, bn)]
    if need_dw:
        tiles += [("dw", e, r, n) for e in experts for r in range(0, D, bm)
                  for n in range(0, F, bn)]
    return [tiles[b::ctas] for b in range(ctas)]


def _check(x, w, active):
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.dtype not in DTYPES:
            raise TypeError(f"moe_gmm: {name} must be a float32 or bfloat16 "
                            f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.dim() != 3:
            raise ValueError(f"moe_gmm: {name} must be 3-D, got "
                             f"{tuple(t.shape)}")
    E, C, D = x.shape
    F = w.shape[-1]
    if w.shape != (E, D, F):
        raise ValueError(f"moe_gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("moe_gmm: x and w must share dtype and device")
    if active is not None:
        if (active.shape != (E,) or active.dtype not in _ACTIVE_BYTES
                or active.device != x.device):
            raise TypeError(f"moe_gmm: active must be a [{E}] bool or int32 "
                            f"tensor on {x.device}, got {active.dtype} "
                            f"{tuple(active.shape)} on {active.device}")
        active = active.contiguous()
    return active


def _launch(x, w, active):
    """One K7 launch on checked operands (uncounted)."""
    x, w = x.contiguous(), w.contiguous()
    E, C, D = x.shape
    F = w.shape[-1]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, False
    if D == 0:
        return out.zero_(), False
    err = _build.load("moe_gmm").moe_gmm_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
        out.data_ptr(), None if active is None else active.data_ptr(),
        0 if active is None else _ACTIVE_BYTES[active.dtype], E, C, D, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "moe_gmm kernel")
    return out, True


def moe_gmm_cuda(x, w, active=None):
    """x [E, C, D], w [E, D, F] on the card, one dtype (float32 or
    bfloat16) -> [E, C, F] in that dtype, float32 sums over D.  `active`
    ([E] bool or int32 on the card, or None for all) marks the experts
    to multiply; the others' outputs are zero."""
    active = _check(x, w, active)
    out, launched = _launch(x, w, active)
    moe_gmm_cuda.launches += launched
    return out


moe_gmm_cuda.launches = 0


def _bwd_tensor_cores(dy, x, w):
    """Whether the backward kernel takes these operands: bfloat16, D and
    F multiples of 8, every pointer 16-byte aligned."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and w.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (dy, x, w)))


def moe_gmm_bwd_cuda(dy, x, w, active=None, need_dx=True, need_dw=True):
    """The gradient of `moe_gmm_cuda(x, w, active)` given the output's
    gradient dy [E, C, F] -> (dx [E, C, D], dw [E, D, F]) (None where not
    needed), in x's dtype, float32 sums; the inactive experts' dx and dw
    are zero.  bfloat16 with D and F multiples of 8 and 16-byte aligned
    operands: one launch of the backward kernel, counted once, on dy, x
    and w as they lie (contiguous, else ValueError).  Otherwise two
    launches of the forward kernel, dx = K7(dy, wᵀ) and dw = K7(xᵀ, dy),
    each counted."""
    active = _check(x, w, active)
    E, C, D = x.shape
    F = w.shape[-1]
    if (dy.shape != (E, C, F) or dy.dtype != x.dtype
            or dy.device != x.device):
        raise ValueError(f"moe_gmm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device} does not match the "
                         "output")
    if not _bwd_tensor_cores(dy, x, w):
        dx = dw = None
        if need_dx:
            dx, launched = _launch(dy, w.transpose(1, 2), active)
            moe_gmm_bwd_cuda.launches += launched
        if need_dw:
            dw, launched = _launch(x.transpose(1, 2), dy, active)
            moe_gmm_bwd_cuda.launches += launched
        return dx, dw
    for name, t in (("dy", dy), ("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm backward: {name} must be contiguous")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if dx is None and dw is None:
        return dx, dw
    if min(E, C, D, F) == 0:          # nothing to sum: zeros, no launch
        for t in (dx, dw):
            if t is not None:
                t.zero_()
        return dx, dw
    err = _build.load("moe_gmm_bwd").moe_gmm_bwd_launch(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(),
        None if dx is None else dx.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if active is None else active.data_ptr(),
        0 if active is None else _ACTIVE_BYTES[active.dtype], E, C, D, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "moe_gmm_bwd kernel")
    moe_gmm_bwd_cuda.launches += 1
    return dx, dw


moe_gmm_bwd_cuda.launches = 0


class MoeGmmFn(torch.autograd.Function):
    """K7 under autograd: the forward launch, then the backward's
    (`moe_gmm_bwd_cuda`) for dx and dw."""

    @staticmethod
    def forward(ctx, x, w, active):
        ctx.save_for_backward(x, w, active)
        return moe_gmm_cuda(x, w, active)

    @staticmethod
    def backward(ctx, dy):
        x, w, active = ctx.saved_tensors
        dx, dw = moe_gmm_bwd_cuda(dy.contiguous(), x, w, active,
                                  ctx.needs_input_grad[0],
                                  ctx.needs_input_grad[1])
        return dx, dw, None
