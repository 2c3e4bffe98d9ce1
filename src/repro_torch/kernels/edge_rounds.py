"""Wrappers of the Hopper fixed-point kernels (`csrc/edge_rounds.cu`).

`edge_rounds_cuda` replaces the JAX package's Pallas kernel
`kernels/edge_rounds.py:edge_rounds` and `edge_rounds_bucketed_cuda`
its `edge_rounds_bucketed`.  Both run the whole early-exit loop in one
launch, one CTA per task row, and agree bit for bit with their plain
versions in `kernels/ref.py` (`edge_rounds_ref`,
`edge_rounds_bucketed_ref`), which take the tensors that lie on the CPU.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

__all__ = ["EdgeBuckets", "edge_rounds_cuda", "edge_rounds_bucketed_cuda",
           "max_nodes"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 232448            # dynamic shared memory a block can use


def max_nodes() -> int:
    """Largest V whose two f32 state rows fit one CTA's shared memory."""
    return _SMEM_BYTES // 8


@dataclasses.dataclass(frozen=True)
class EdgeBuckets:
    """Degree-bucketed tiles of ONE edge direction, laid end to end.

    Bucket k owns rows [row_off[k], row_off[k+1]) of `nodes` and lanes
    [lane_off[k], lane_off[k+1]) of nbr/wsrc/wslot/mask, as a
    [rows_k, widths[k]] tile in row-major order.  Row r of a bucket is
    node nodes[r]; its lanes gather the state at `nbr` (out: the head j;
    in: the tail i) and the weight at [wsrc, wslot] of the [.., V, Dmax]
    slot array.  Widths are powers of two clamped to Dmax."""
    nodes: torch.Tensor      # [V] int32
    nbr: torch.Tensor        # [lanes] int32
    wsrc: torch.Tensor       # [lanes] int32
    wslot: torch.Tensor      # [lanes] int32
    mask: torch.Tensor       # [lanes] uint8
    row_off: torch.Tensor    # [n+1] int32
    lane_off: torch.Tensor   # [n+1] int64
    width: torch.Tensor      # [n] int32
    widths: tuple            # the same widths as python ints
    lanes: int               # ΣVb·Db, the lanes of one round

    @classmethod
    def from_tiles(cls, nodes, nbr, wsrc, wslot, mask, device):
        """From per-bucket numpy tiles: nodes [Vb], the others [Vb, Db]."""
        widths = tuple(int(t.shape[1]) for t in nbr)
        rows = np.cumsum([0] + [t.shape[0] for t in nodes])
        lanes = np.cumsum([0] + [t.size for t in nbr])

        def flat(ts, dtype):
            return torch.as_tensor(np.concatenate([t.reshape(-1) for t in ts]),
                                   device=device).to(dtype)

        return cls(nodes=flat(nodes, torch.int32), nbr=flat(nbr, torch.int32),
                   wsrc=flat(wsrc, torch.int32),
                   wslot=flat(wslot, torch.int32),
                   mask=flat(mask, torch.uint8),
                   row_off=torch.tensor(rows, dtype=torch.int32,
                                        device=device),
                   lane_off=torch.tensor(lanes, dtype=torch.int64,
                                         device=device),
                   width=torch.tensor(widths, dtype=torch.int32,
                                      device=device),
                   widths=widths, lanes=int(lanes[-1]))


def _slots_per_lane(width: int) -> int:
    P = 1 if width <= 1 else 1 << (width - 1).bit_length()
    return max(P // 32, 1)


def _operands(w, b, V: int, widest: int, what: str):
    if w.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors only")
    if w.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16 weights and "
                        f"injects, got {w.dtype} and {b.dtype}")
    if V > max_nodes():
        raise ValueError(
            f"{what}: V={V} exceeds the {max_nodes()} nodes whose state fits "
            "one CTA's shared memory (the multi-CTA design is not built)")
    if widest > 32 * 32:
        raise ValueError(f"{what}: tile width {widest} exceeds 1024")
    if w.dtype != b.dtype:           # exact: bf16 widens to f32
        w, b = w.float(), b.float()
    return w.contiguous(), b.contiguous(), _DTYPE_CODE[w.dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(reduce, shift, max_rounds, w, b, dt, cw, nbr, mask, csr=None):
    """One launch; `nbr`/`mask` are the padded tiles, or the CSR lanes
    when `csr` is given."""
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    S, V, D = w.shape
    out = torch.empty((S, V), dtype=w.dtype, device=w.device)
    rounds = torch.empty((S,), dtype=torch.int32, device=w.device)
    if S == 0:
        return out, rounds[:0]
    if nbr.device != w.device or mask.device != w.device:
        raise ValueError("edge_rounds: index tiles must lie on the weights' "
                         "device")
    b32 = torch.empty((S, V), dtype=torch.float32, device=w.device)
    wtile = None if csr is None else torch.empty(
        (S, csr.lanes), dtype=torch.float32, device=w.device)
    c = csr if csr is not None else EdgeBuckets(*([None] * 8), (), 0)
    err = _build.load("edge_rounds").edge_rounds_launch(
        int(reduce == "max"), cw, dt, dt, int(csr is not None),
        w.data_ptr(), b.data_ptr(), _ptr(c.nodes), nbr.data_ptr(),
        _ptr(c.wsrc), _ptr(c.wslot), mask.data_ptr(), _ptr(c.row_off),
        _ptr(c.lane_off), _ptr(c.width), len(c.widths), c.lanes,
        out.data_ptr(), rounds.data_ptr(), S, V, D, float(shift),
        int(max_rounds), b32.data_ptr(), _ptr(wtile),
        torch.cuda.current_stream(w.device).cuda_stream)
    (edge_rounds_cuda if csr is None
     else edge_rounds_bucketed_cuda).launches += 1
    _build.check(err, "edge_rounds kernel")
    return out, rounds


def edge_rounds_cuda(w_sp, inject, nbr, mask, reduce: str = "sum",
                     shift: float = 0.0, max_rounds: int | None = None):
    """w_sp [S, V, Dmax], inject [S, V], nbr [V, Dmax] int32 and mask
    [V, Dmax] uint8 on the card -> (x [S, V] in the promoted dtype,
    int32 [S] rounds each task row ran)."""
    V, D = nbr.shape
    w, b, dt = _operands(w_sp, inject, V, D, "edge_rounds")
    if nbr.dtype != torch.int32 or mask.dtype != torch.uint8:
        raise TypeError("edge_rounds takes int32 nbr and uint8 mask tiles")
    max_rounds = V if max_rounds is None else max_rounds
    return _launch(reduce, shift, max_rounds, w, b, dt, _slots_per_lane(D),
                   nbr.contiguous(), mask.contiguous())


def edge_rounds_bucketed_cuda(w_sp, inject, csr: EdgeBuckets,
                              reduce: str = "sum", shift: float = 0.0,
                              max_rounds: int | None = None):
    """`edge_rounds_cuda` over the degree buckets of `csr`; w_sp is the
    [S, V, Dmax] out-edge-slot weight array."""
    V = csr.nodes.shape[0]
    w, b, dt = _operands(w_sp, inject, V, max(csr.widths),
                         "edge_rounds_bucketed")
    max_rounds = V if max_rounds is None else max_rounds
    return _launch(reduce, shift, max_rounds, w, b, dt,
                   _slots_per_lane(max(csr.widths)), csr.nbr, csr.mask, csr)


edge_rounds_cuda.launches = 0
edge_rounds_bucketed_cuda.launches = 0
