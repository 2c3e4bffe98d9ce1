"""Wrapper of the Hopper Eq. 15 QP kernel (`csrc/simplex_project.cu`).

`simplex_project_cuda` replaces the JAX package's Pallas kernel
`kernels/simplex_project.py:simplex_project`, following its oracle
`core/sgp.py:project_rows` (the plain version here is
`kernels/ref.py:simplex_project_ref`).  Each warp takes a batch of
`rows_per_warp(K)` rows, compacts every row's permitted coordinates and
solves the rows in sub-warp groups sized to their permitted counts (a
whole warp for rows with more than 32).  Launches are counted in
`.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rows_per_warp", "simplex_project_cuda"]

MAX_WIDTH = 16 * 32
STAGE_BYTES = 2304       # mask bytes a warp's batch of rows stages, about
MAX_ROWS = 16            # rows a batch may hold (csrc kMaxRows: 32)


def rows_per_warp(K: int) -> int:
    """Rows of one warp's batch: about STAGE_BYTES of mask, 1 to MAX_ROWS
    rows (16 at sw_1000's K = 15, 8 at ba_10000's K = 278)."""
    return max(1, min(MAX_ROWS, STAGE_BYTES // max(K, 1)))


def simplex_project_cuda(phi, delta, M, permitted, n_iter: int = 60):
    """phi, delta, M [R, K] float32 and permitted [R, K] bool on the card
    -> projected rows [R, K] float32."""
    R, K = phi.shape
    for name, t in (("phi", phi), ("delta", delta), ("M", M)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"simplex_project: {name} must be a float32 "
                            f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.shape != (R, K):
            raise ValueError(f"simplex_project: {name} {tuple(t.shape)} "
                             f"is not [{R}, {K}]")
    if permitted.dtype != torch.bool or permitted.shape != (R, K) \
            or permitted.device != phi.device:
        raise TypeError("simplex_project: permitted must be a bool [R, K] "
                        "tensor on the rows' device")
    if K > MAX_WIDTH:
        raise ValueError(f"simplex_project: K={K} exceeds {MAX_WIDTH}")
    out = torch.empty((R, K), dtype=torch.float32, device=phi.device)
    if R == 0 or K == 0:
        return out
    phi, delta, M = phi.contiguous(), delta.contiguous(), M.contiguous()
    perm = permitted.contiguous().view(torch.uint8)
    err = _build.load("simplex_project").simplex_project_launch(
        rows_per_warp(K), phi.data_ptr(), delta.data_ptr(),
        M.data_ptr(), perm.data_ptr(), out.data_ptr(), R, K, int(n_iter),
        torch.cuda.current_stream(phi.device).cuda_stream)
    simplex_project_cuda.launches += 1
    _build.check(err, "simplex_project kernel")
    return out


simplex_project_cuda.launches = 0
