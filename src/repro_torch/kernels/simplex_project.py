"""Wrapper of the Hopper Eq. 15 QP kernel (`csrc/simplex_project.cu`).

`simplex_project_cuda` replaces the JAX package's Pallas kernel
`kernels/simplex_project.py:simplex_project`, following its oracle
`core/sgp.py:project_rows` (the plain version here is
`kernels/ref.py:simplex_project_ref`).  Each warp takes a batch of
`rows_per_warp(K)` rows, compacts every row's permitted coordinates and
solves the rows in sub-warp groups sized to their permitted counts (a
whole warp for rows with more than 32, from registers up to 512 of them
and streamed from the row's column list beyond).  The width K is bounded
by the block's shared memory (`smem_bytes`), not by the registers: the
dense engine's rows [S·V, V+1] (K = 1001 at sw_1000) permit at most a
node's out-degree + 1 coordinates.  Launches are counted in `.launches`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["plan", "rows_per_warp", "simplex_project_cuda", "smem_bytes"]

STAGE_BYTES = 2304       # mask bytes a warp's batch of rows stages, about
MAX_ROWS = 16            # rows a batch may hold (csrc kMaxRows: 32)
WARPS = 8                # warps a block (csrc kThreads / 32)
SMEM_LIMIT = 227 * 1024  # shared memory a block may take on sm_90
MAX_WIDTH = 32767        # the column lists are 16-bit


def rows_per_warp(K: int) -> int:
    """Rows of one warp's batch: about STAGE_BYTES of mask, 1 to MAX_ROWS
    rows (16 at sw_1000's sparse K = 15, 8 at ba_10000's K = 278, 2 at
    the dense K = 1001 of sw_1000, 1 above K = 1152)."""
    return max(1, min(MAX_ROWS, STAGE_BYTES // max(K, 1)))


def smem_bytes(K: int) -> int:
    """A block's shared memory at width K (csrc `WarpSmem`): per warp the
    staged mask, the narrow rows' column lists, the wide row's column
    list and the per-row counts."""
    def r16(n):
        return (n + 15) & ~15
    B = rows_per_warp(K)
    cols = r16(B * K + 48)
    return WARPS * (cols + B * 64 + r16(2 * K) + 160)


def plan(K: int) -> dict:
    """The launch plan at width K: rows a warp's batch, registers a lane
    of the whole-warp route (rows with more permitted coordinates than
    32 × that are streamed) and the block's shared memory.  Raises
    ValueError where the block's shared memory cannot hold it."""
    smem = smem_bytes(K)
    if not 1 <= K <= MAX_WIDTH or smem > SMEM_LIMIT:
        raise ValueError(f"simplex_project: K={K} needs {smem} bytes of "
                         f"shared memory a block (limit {SMEM_LIMIT}; K "
                         f"at most {MAX_WIDTH})")
    return {"rows_per_warp": rows_per_warp(K),
            "registers": min(16, -(-K // 32)), "smem_bytes": smem}


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
    out = torch.empty((R, K), dtype=torch.float32, device=phi.device)
    if R == 0 or K == 0:
        return out
    p = plan(K)
    phi, delta, M = phi.contiguous(), delta.contiguous(), M.contiguous()
    perm = permitted.contiguous().view(torch.uint8)
    err = _build.load("simplex_project").simplex_project_launch(
        p["rows_per_warp"], phi.data_ptr(), delta.data_ptr(),
        M.data_ptr(), perm.data_ptr(), out.data_ptr(), R, K, int(n_iter),
        torch.cuda.current_stream(phi.device).cuda_stream)
    simplex_project_cuda.launches += 1
    _build.check(err, "simplex_project kernel")
    return out


simplex_project_cuda.launches = 0
