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

Under autograd (`MoeGmmFn`) the backward is two more launches of the
same kernel with the same `active` (`moe_gmm_bwd_cuda`): dx = K7(dy,
wᵀ) and dw = K7(xᵀ, dy), xᵀ [E, D, C] and wᵀ [E, F, D] made contiguous
first (the transposes move E·C·D + E·D·F elements once, each read and
written); no library matmul.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["MoeGmmFn", "moe_gmm_bwd_cuda", "moe_gmm_cuda", "tile_schedule",
           "tile_width"]

DTYPES = (torch.float32, torch.bfloat16)
MAX_M = 128                  # rows of one tile (csrc kMaxM)


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


def moe_gmm_bwd_cuda(dy, x, w, active=None, need_dx=True, need_dw=True):
    """The gradient of `moe_gmm_cuda(x, w, active)` given the output's
    gradient dy [E, C, F] -> (dx [E, C, D], dw [E, D, F]) (None where not
    needed): dx = K7(dy, wᵀ), dw = K7(xᵀ, dy), both with `active`, in
    x's dtype, float32 sums.  Each of the two launches is counted."""
    active = _check(x, w, active)
    E, C, D = x.shape
    if dy.shape != (E, C, w.shape[-1]) or dy.dtype != x.dtype:
        raise ValueError(f"moe_gmm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match the output")
    dx = dw = None
    if need_dx:
        dx, launched = _launch(dy, w.transpose(1, 2), active)
        moe_gmm_bwd_cuda.launches += launched
    if need_dw:
        dw, launched = _launch(x.transpose(1, 2), dy, active)
        moe_gmm_bwd_cuda.launches += launched
    return dx, dw


moe_gmm_bwd_cuda.launches = 0


class MoeGmmFn(torch.autograd.Function):
    """K7 under autograd: the forward launch, then two launches of the
    same kernel for dx and dw (`moe_gmm_bwd_cuda`)."""

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
