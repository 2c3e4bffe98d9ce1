"""Wrapper of the Hopper grouped matmul kernel (`csrc/moe_gmm.cu`).

`moe_gmm_cuda` replaces the JAX package's Pallas kernel
`src/repro/kernels/moe_gmm.py:35` (`moe_gmm`); its plain version is
`kernels/ref.py:moe_gmm_ref`.  It takes any E, C, D and F (the Pallas
kernel asserts multiples of its tiles): the MoE layer's capacity C is
ragged (52 at a 333-token prompt).

What bounds it on the H100: bytes.  One launch reads one layer's expert
weight (268 MB in bf16 at OLMoE's 64 x 2048 x 1024) against at most
21.5 GFLOP, so each CTA holds all C rows of its expert and reads its
tile of w once; bfloat16 multiplies on the tensor cores, float32 on
CUDA cores (the source's header says why).  Launches are counted in
`.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["moe_gmm_cuda"]

DTYPES = (torch.float32, torch.bfloat16)


def moe_gmm_cuda(x, w):
    """x [E, C, D], w [E, D, F] on the card, one dtype (float32 or
    bfloat16) -> [E, C, F] in that dtype, float32 sums over D."""
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
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    err = _build.load("moe_gmm").moe_gmm_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
        out.data_ptr(), E, C, D, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    moe_gmm_cuda.launches += 1
    _build.check(err, "moe_gmm kernel")
    return out


moe_gmm_cuda.launches = 0
